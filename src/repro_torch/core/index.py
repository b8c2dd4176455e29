"""Batched multi-query WMD engine over a frozen corpus index (port of
``repro.core.index``).

``CorpusIndex``
    Freezes everything query-independent once, on the device: the ELL
    document collection, the vocabulary embeddings and their squared
    norms, per-doc mass centroids (the WCD bound), nnz-sorted
    width-trimmed :class:`DocGroup` slices, the IVF k-means clustering
    (documents are stored cluster-major; ``ext_ids``/``remap`` translate
    to the caller's doc order at the output boundary) and the pivot-word
    distance table. :func:`build_index` builds it with a torch k-means;
    :func:`index_from_arrays` takes the arrays the reference's
    ``save_index`` writes and rebuilds the same storage order and groups.
    :func:`save_index` / :func:`load_index` (``CorpusIndex.save`` /
    ``.load``) persist it to one checksummed ``.npz`` file with the
    reference's keys and dtypes, so a file written by either package
    loads in the other; :func:`index_to_device` moves it to another
    device.

``WmdEngine``
    Shape-buckets queries to power-of-two ``v_r`` sizes (padded query rows
    carry ``r = 1, G = 0`` — inert in the solver), stacks each chunk of up
    to ``max_batch`` queries into one problem and runs, per chunk: one
    stacked cdist GEMM for the K block, a gather of each doc group's K
    columns, and the solve. Two solve impls, as in the reference:
    ``impl="kernel"`` launches the Hopper solver K1
    (:func:`repro_torch.kernels.ops.sinkhorn_fused_all_batched`);
    ``impl="sparse"`` runs the batched einsum solve
    (:func:`_solve_batched_einsum`, plain torch, as the reference leaves it
    to XLA), which also exposes the converged profile that warm-starts
    survivor solves (``warm_start``), and can assemble its K block from
    the cross-request K-column cache (``kcache_slots``,
    :mod:`.kcache`). ``search`` is the staged exact top-k: RWMD (or WCD)
    bounds through the Hopper kernel K2, a seed solve that sets each
    query's threshold, a survivor solve, and a rank. With an IVF cascade
    (``prune="ivf+..."``) the bounds run cheapest-first over a shrinking
    candidate set, the RWMD stage through K2s; ``mode="refine"`` ranks by
    the bound and solves each query's best ``refine_factor * k``. On a CPU
    index the same code calls the kernels' plain versions.

fp32 policy: every product here is full fp32. PyTorch's default on the
card (``torch.backends.cuda.matmul.allow_tf32 is False``) is relied on,
never changed, and ``chip_smoke.py`` asserts it: TF32 keeps ~3 decimal
digits and would move both the prune bounds and the distances.
"""
from __future__ import annotations

import collections
import zlib
from typing import NamedTuple, Sequence

import numpy as np
import torch

from .. import trace
from .device import resolve_device
from .sinkhorn import (LamUnderflowError, gemm_round, select_support,
                       underflow_report)
from .kcache import cdist_rows, kq_from_m
from .sinkhorn_sparse import (SolvePrecision, _inv, _select, adaptive_loop,
                              adaptive_loop_scoped, gather_columns,
                              marginal_residual, marginal_residual_per_query)
from .sparse import PaddedDocs


class DocGroup(NamedTuple):
    """One length-homogeneous slice of the corpus, ELL-trimmed to its own
    max word count."""

    docs: PaddedDocs    # device idx (N_g, L_g) int64 / val (N_g, L_g) fp32
    cols: np.ndarray    # (N_g,) host: storage doc ids (for reassembly)


class IvfClusters(NamedTuple):
    """Frozen IVF coarse quantizer over the per-doc WCD centroids."""

    centers: torch.Tensor   # (C, w) cluster centers, device
    assign: np.ndarray      # (N,) host: cluster id per doc
    order: np.ndarray       # (N,) host: doc ids sorted by cluster id
    starts: np.ndarray      # (C + 1,) host: cluster c owns
    #                         order[starts[c]:starts[c + 1]]
    radii: np.ndarray       # (C,) host: max ||center_c - centroid_n||
    assign_dev: torch.Tensor  # (N,) device mirror of ``assign``

    @property
    def n_clusters(self) -> int:
        return self.centers.shape[0]

    @property
    def sizes(self) -> np.ndarray:
        return np.diff(self.starts)


class CorpusIndex(NamedTuple):
    """Query-independent corpus state, frozen once and reused. Per-doc
    arrays are in cluster-major STORAGE order; ``ext_ids`` maps storage ->
    the caller's doc id and ``remap`` is its inverse."""

    docs: PaddedDocs        # device ELL corpus: idx (N, L) int64, val fp32
    groups: tuple           # tuple[DocGroup, ...]: nnz-sorted, width-trimmed
    vecs: torch.Tensor      # (V, w) vocabulary embeddings, device
    vecs_sq: torch.Tensor   # (V,) per-word |b|^2
    centroids: torch.Tensor  # (N, w) per-doc mass centroids (WCD bound)
    docs_host: PaddedDocs   # numpy mirror of ``docs`` (idx int32)
    clusters: IvfClusters = None
    ext_ids: np.ndarray = None   # (N,) host: storage id -> caller doc id
    remap: np.ndarray = None     # (N,) host: caller doc id -> storage id
    pivots: torch.Tensor = None  # (P, w) pivot word embeddings
    doc_pivot_d: torch.Tensor = None  # (N, P) ||centroid_n - pivot_p||

    @property
    def n_docs(self) -> int:
        return self.docs.idx.shape[0]

    @property
    def vocab_size(self) -> int:
        return self.vecs.shape[0]

    @property
    def embed_dim(self) -> int:
        return self.vecs.shape[1]

    @property
    def device(self) -> torch.device:
        return self.vecs.device

    def save(self, path) -> None:
        """Persist this index to one checksummed ``.npz`` file (see
        :func:`save_index`)."""
        save_index(self, path)

    @staticmethod
    def load(path, device=None) -> "CorpusIndex":
        """Rebuild an index from a :meth:`save` file (see
        :func:`load_index`); raises ``ValueError`` if its checksum or
        format version does not match."""
        return load_index(path, device=device)

    def to_external(self, storage_ids) -> np.ndarray:
        """Storage ids -> the caller's original doc ids."""
        storage_ids = np.asarray(storage_ids, np.int32)
        if self.ext_ids is None:
            return storage_ids
        return self.ext_ids[storage_ids]

    def subset(self, doc_ids, storage: bool = False) -> DocGroup:
        """Candidate-subset slice for the solve stage: ``doc_ids`` gathered
        out of the host mirror into one width-trimmed :class:`DocGroup`
        (slots are front-compacted at build, so trimming to the subset's
        max nnz loses nothing). ``doc_ids`` are caller ids unless
        ``storage=True``. The doc count is padded to a power of two (>= 8)
        with inert all-zero docs and the width to a multiple of 8, as in
        the reference; ``cols`` keeps only the real ids."""
        with trace.span("wmd.subset") as s:
            doc_ids = np.asarray(doc_ids, np.int32)
            rows = doc_ids
            if not storage and self.remap is not None:
                rows = self.remap[doc_ids]
            idx = self.docs_host.idx[rows]
            val = self.docs_host.val[rows]
            lg = max(1, int((val > 0).sum(axis=1).max(initial=0)))
            lg = min(-(-lg // 8) * 8, idx.shape[1])
            n_pad = 8
            while n_pad < doc_ids.size:
                n_pad *= 2
            pad = ((0, n_pad - doc_ids.size), (0, 0))
            # the ids widen on the host: a blocking copy converts there
            idx = np.pad(idx[:, :lg], pad).astype(np.int64)
            val = np.pad(val[:, :lg], pad)
            if s:
                trace.add("h2d_pageable_bytes", idx.nbytes + val.nbytes)
            dev = self.device
            return DocGroup(docs=PaddedDocs(
                idx=torch.as_tensor(idx, device=dev),
                val=torch.as_tensor(val, device=dev)), cols=doc_ids)


# ---------------------------------------------------------------- k-means
def _assign_clusters(points: torch.Tensor,
                     centers: torch.Tensor) -> torch.Tensor:
    """Nearest-center assignment for one mini-batch: (B, w) -> (B,)."""
    d2 = ((points * points).sum(1)[:, None]
          + (centers * centers).sum(1)[None, :]
          - 2.0 * (points @ centers.T))
    return torch.argmin(d2, dim=1)


def _farthest_point_init(points: torch.Tensor, c: int,
                         start: int) -> torch.Tensor:
    """Maxmin seeding: each new center is the point farthest from all
    chosen so far. Deterministic, on the device."""
    mind = ((points - points[start]) ** 2).sum(1)
    centers = torch.zeros((c, points.shape[1]), dtype=points.dtype,
                          device=points.device)
    centers[0] = points[start]
    for i in range(1, c):
        cen = points[torch.argmax(mind)]
        centers[i] = cen
        mind = torch.minimum(mind, ((points - cen) ** 2).sum(1))
    return centers


def _kmeans(centroids: torch.Tensor, n_clusters: int, n_iters: int = 10,
            batch: int = 4096, seed: int = 0, init_sample: int = 65536):
    """Mini-batch Lloyd k-means over the doc centroids, on the device:
    farthest-point init (on an ``init_sample``-capped subset), then
    ``n_iters`` exact updates streamed in ``batch`` slices; empty clusters
    keep their center. Returns (centers (C, w), assign host (N,))."""
    n = centroids.shape[0]
    rng = np.random.default_rng(seed)
    pool = centroids
    if n > init_sample:
        keep = np.sort(rng.choice(n, size=init_sample, replace=False))
        pool = centroids[torch.as_tensor(keep, device=centroids.device)]
    centers = _farthest_point_init(pool, n_clusters,
                                   int(rng.integers(pool.shape[0])))
    for _ in range(n_iters):
        sums = torch.zeros_like(centers)
        counts = torch.zeros((n_clusters,), dtype=centers.dtype,
                             device=centers.device)
        for lo in range(0, n, batch):
            pts = centroids[lo:lo + batch]
            a = _assign_clusters(pts, centers)
            sums.index_add_(0, a, pts)
            counts += torch.bincount(a, minlength=n_clusters).to(
                counts.dtype)
        centers = torch.where(counts[:, None] > 0,
                              sums / torch.clamp(counts, min=1.0)[:, None],
                              centers)
    assign = torch.cat([_assign_clusters(centroids[lo:lo + batch], centers)
                        for lo in range(0, n, batch)])
    return centers, assign.cpu().numpy().astype(np.int32)


def _pivot_dists(points: torch.Tensor, pivots: torch.Tensor) -> torch.Tensor:
    """(M, w) points x (P, w) pivots -> (M, P) Euclidean distances."""
    a2 = (points * points).sum(1)[:, None]
    b2 = (pivots * pivots).sum(1)[None, :]
    d2 = a2 + b2 - 2.0 * (points @ pivots.T)
    return torch.sqrt(torch.clamp(d2, min=0.0))


def _select_pivots(vecs: torch.Tensor, n_pivots: int, seed: int = 0,
                   sample: int = 65536) -> torch.Tensor:
    """Farthest-point pivot words over the (sample-capped) vocabulary."""
    v = vecs.shape[0]
    n_pivots = max(1, min(int(n_pivots), v))
    rng = np.random.default_rng(seed)
    pool = vecs
    if v > sample:
        keep = np.sort(rng.choice(v, size=sample, replace=False))
        pool = vecs[torch.as_tensor(keep, device=vecs.device)]
    return _farthest_point_init(pool, n_pivots,
                                int(rng.integers(pool.shape[0])))


def _membership(assign: np.ndarray, n_clusters: int):
    """(order, starts): cluster c's docs are order[starts[c]:starts[c+1]]."""
    order = np.argsort(assign, kind="stable").astype(np.int32)
    starts = np.searchsorted(assign[order],
                             np.arange(n_clusters + 1)).astype(np.int64)
    return order, starts


MEMBER_CHUNK = 4096     # docs per distance block in _member_dists


def _member_dists(centroids: torch.Tensor, centers: torch.Tensor,
                  assign: np.ndarray) -> np.ndarray:
    """(N,) host distances from each doc centroid to its assigned center."""
    assign_dev = torch.as_tensor(assign.astype(np.int64),
                                 device=centers.device)
    out = [torch.linalg.norm(centroids[lo:lo + MEMBER_CHUNK]
                             - centers[assign_dev[lo:lo + MEMBER_CHUNK]],
                             dim=1)
           for lo in range(0, assign.shape[0], MEMBER_CHUNK)]
    if not out:
        return np.zeros(0, np.float64)
    return torch.cat(out).cpu().numpy().astype(np.float64)


def _cluster_radii(centroids: torch.Tensor, centers: torch.Tensor,
                   assign: np.ndarray, n_clusters: int) -> np.ndarray:
    """(C,) max member distance per cluster (0 for empty clusters)."""
    radii = np.zeros(n_clusters, np.float64)
    if assign.size:
        np.maximum.at(radii, assign, _member_dists(centroids, centers,
                                                   assign))
    return radii


def default_n_clusters(n_docs: int) -> int:
    """sqrt(N) coarse-quantizer heuristic (classic IVF sizing)."""
    return max(1, min(n_docs, int(round(float(np.sqrt(max(n_docs, 1)))))))


# auto_n_clusters' sweep: at most AUTO_SAMPLE doc centroids, AUTO_SWEEP_ITERS
# k-means iterations per count, and a doubling that shrinks the weighted
# mean radius below AUTO_DROP of the previous one is a collapse
AUTO_SAMPLE = 2048
AUTO_SWEEP_ITERS = 4
AUTO_DROP = 0.7


def auto_n_clusters(centroids, seed: int = 0) -> int:
    """Data-tuned cluster count from cluster-radius statistics (the
    reference's rule, on the port's torch k-means).

    Once the cluster count reaches a dedup-style corpus' near-duplicate
    group count, the mass-weighted mean cluster radius collapses; a
    diffuse corpus has no such elbow. So: sweep cluster counts by doubling
    over an ``AUTO_SAMPLE``-capped subset of the doc centroids (a short
    k-means each), and return the largest count whose doubling shrank the
    weighted mean radius below ``AUTO_DROP`` of the previous one, scaled
    back to the full corpus size; with no collapse below ``m // 8``, the
    sqrt default.
    ``centroids`` is a (N, w) tensor (its device runs the sweep) or
    array. Spelled ``n_clusters="auto"`` in :func:`build_index` and the
    serve CLI. The torch k-means may settle near-ties differently from the
    reference's, so the count can differ from the reference's on some
    corpora."""
    pts = (centroids if isinstance(centroids, torch.Tensor)
           else torch.from_numpy(np.array(centroids, np.float32)))
    n = pts.shape[0]
    if n <= 4:
        return max(1, n)
    rng = np.random.default_rng(seed)
    if n > AUTO_SAMPLE:
        pick = np.sort(rng.choice(n, size=AUTO_SAMPLE, replace=False))
        pts = pts[torch.as_tensor(pick, device=pts.device)]
    m = pts.shape[0]
    best = prev = None
    c = 2
    while c <= max(4, m // 8):
        centers, assign = _kmeans(pts, c, n_iters=AUTO_SWEEP_ITERS,
                                  seed=seed)
        radii = _cluster_radii(pts, centers, assign, c)
        sizes = np.bincount(assign, minlength=c)
        wmean = float((sizes * radii).sum() / max(m, 1))
        if prev is not None and wmean < AUTO_DROP * prev:
            best = c
        prev = wmean
        c *= 2
    if best is None:
        # no collapse: the sqrt default of the full corpus
        return default_n_clusters(n)
    # a collapse point is a density statement about the sample: scale it
    return max(1, min(n, int(round(best * n / m))))


# ------------------------------------------------------------ index build
def _compact_slots(docs: PaddedDocs, dtype=np.float32):
    """Host copies with live slots compacted to the front."""
    idx_np = _host(docs.idx).astype(np.int32)
    val_np = _host(docs.val).astype(dtype)
    slot_order = np.argsort(~(val_np > 0), axis=1, kind="stable")
    return (np.take_along_axis(idx_np, slot_order, 1),
            np.take_along_axis(val_np, slot_order, 1))


def _doc_centroids(idx: torch.Tensor, val: torch.Tensor, vecs: torch.Tensor,
                   chunk: int = 2048) -> torch.Tensor:
    """Per-doc mass centroids sum_l val[n,l] * vecs[idx[n,l]], chunked so
    the (n, L, w) gather stays small."""
    n = idx.shape[0]
    out = torch.empty((n, vecs.shape[1]), dtype=vecs.dtype,
                      device=vecs.device)
    for lo in range(0, n, chunk):
        out[lo:lo + chunk] = torch.einsum("nl,nlw->nw", val[lo:lo + chunk],
                                          vecs[idx[lo:lo + chunk]])
    return out


def build_index(docs: PaddedDocs, vecs, device=None, doc_groups: int = 4,
                n_clusters=None, ivf_iters: int = 10, ivf_seed: int = 0,
                clusters=None, n_pivots: int = 8,
                pivot_seed: int = 0) -> CorpusIndex:
    """Freeze the corpus side on ``device`` (``None`` -> ``cuda``; raises
    when no CUDA device is present): ELL docs, embeddings and norms,
    per-doc centroids, the IVF k-means (torch, on the device), the
    cluster-major storage permutation, nnz groups and pivot distances.

    ``n_clusters`` is an int, ``None`` (the sqrt(N) default), ``"auto"``
    (:func:`auto_n_clusters`'s radius sweep) or a numeric string (CLI
    passthrough). ``clusters=(centers, assign)`` skips the k-means and
    freezes the given quantizer. The index is lossless: engine results
    over it do not depend on ``doc_groups``, ``n_clusters``, ``n_pivots``
    or the storage permutation, which only steer pruning — so this k-means
    may settle near-tie assignments differently from the reference's and
    the distances stay the same."""
    dev = resolve_device(device)
    vecs_t = torch.as_tensor(np.asarray(_host(vecs), np.float32), device=dev)
    idx_np, val_np = _compact_slots(docs)
    n_docs = idx_np.shape[0]
    centroids = _doc_centroids(
        torch.as_tensor(idx_np, dtype=torch.int64, device=dev),
        torch.as_tensor(val_np, device=dev), vecs_t)
    if clusters is not None:
        pre_centers, pre_assign = clusters
        centers = torch.as_tensor(np.asarray(_host(pre_centers), np.float32),
                                  device=dev)
        assign = np.asarray(pre_assign, np.int32)
        n_clusters = int(centers.shape[0])
        if assign.shape[0] != n_docs:
            raise ValueError(f"precomputed assign has {assign.shape[0]} "
                             f"entries for {n_docs} docs")
        if assign.size and (assign.min() < 0 or assign.max() >= n_clusters):
            raise ValueError("precomputed assign references cluster ids "
                             f"outside [0, {n_clusters})")
    else:
        if isinstance(n_clusters, str):
            if n_clusters == "auto":
                n_clusters = auto_n_clusters(centroids, seed=ivf_seed)
            elif n_clusters.isdigit():
                n_clusters = int(n_clusters)        # CLI passthrough
            else:
                raise ValueError(f"n_clusters must be an int, None, or "
                                 f"'auto', got {n_clusters!r}")
        elif n_clusters is None:
            n_clusters = default_n_clusters(n_docs)
        n_clusters = max(1, min(int(n_clusters), max(n_docs, 1)))
        if n_docs:
            centers, assign = _kmeans(centroids, n_clusters,
                                      n_iters=ivf_iters, seed=ivf_seed)
        else:
            centers = torch.zeros((n_clusters, vecs_t.shape[1]),
                                  device=dev)
            assign = np.zeros((0,), np.int32)
    # cluster-major storage: permute every per-doc array so assign is
    # non-decreasing; ext_ids/remap translate at the output boundary
    perm = np.argsort(assign, kind="stable").astype(np.int32)
    idx_np, val_np, assign = idx_np[perm], val_np[perm], assign[perm]
    centroids = centroids[torch.as_tensor(perm.astype(np.int64),
                                          device=dev)]
    remap = np.empty_like(perm)
    remap[perm] = np.arange(perm.size, dtype=np.int32)
    pivots = doc_pivot_d = None
    if n_pivots and int(n_pivots) > 0:
        pivots = _select_pivots(vecs_t, int(n_pivots), seed=pivot_seed)
        doc_pivot_d = _pivot_dists(centroids, pivots)
    order, starts = _membership(assign, n_clusters)
    return _assemble(idx_np, val_np, vecs_t, centroids, doc_groups,
                     IvfClusters(centers=centers, assign=assign, order=order,
                                 starts=starts,
                                 radii=_cluster_radii(centroids, centers,
                                                      assign, n_clusters),
                                 assign_dev=torch.as_tensor(assign,
                                                            device=dev)),
                     ext_ids=perm, remap=remap, pivots=pivots,
                     doc_pivot_d=doc_pivot_d)


def _nnz_groups(idx_np: np.ndarray, val_np: np.ndarray, doc_groups: int,
                device) -> tuple:
    """nnz-sorted, width-trimmed :class:`DocGroup` split (a pure function
    of (idx, val, doc_groups), as in the reference)."""
    nnz = (val_np > 0).sum(1)
    order = np.argsort(nnz, kind="stable")
    n = max(1, len(order))
    gsz = -(-n // max(1, doc_groups))
    groups = []
    for lo in range(0, len(order), gsz):
        # ascending storage ids within the group == cluster-major
        sel = np.sort(order[lo:lo + gsz])
        lg = max(1, int(nnz[sel].max(initial=0)))
        groups.append(DocGroup(
            docs=PaddedDocs(
                idx=torch.as_tensor(np.ascontiguousarray(idx_np[sel, :lg]),
                                    dtype=torch.int64, device=device),
                val=torch.as_tensor(np.ascontiguousarray(val_np[sel, :lg]),
                                    device=device)),
            cols=sel.astype(np.int32)))
    return tuple(groups)


def _assemble(idx_np, val_np, vecs, centroids, doc_groups, clusters,
              ext_ids, remap, pivots, doc_pivot_d) -> CorpusIndex:
    """Shared tail of :func:`build_index` and :func:`index_from_arrays`:
    device uploads, norms and the nnz groups."""
    dev = vecs.device
    idx_np = np.ascontiguousarray(idx_np, np.int32)
    val_np = np.ascontiguousarray(val_np, np.float32)
    return CorpusIndex(
        docs=PaddedDocs(idx=torch.as_tensor(idx_np, dtype=torch.int64,
                                            device=dev),
                        val=torch.as_tensor(val_np, device=dev)),
        groups=_nnz_groups(idx_np, val_np, doc_groups, dev),
        vecs=vecs, vecs_sq=(vecs * vecs).sum(1), centroids=centroids,
        docs_host=PaddedDocs(idx=idx_np, val=val_np), clusters=clusters,
        ext_ids=ext_ids, remap=remap, pivots=pivots, doc_pivot_d=doc_pivot_d)


INDEX_SNAPSHOT_VERSION = 1


def snapshot_checksum(arrays: dict) -> int:
    """CRC32 over every array's name, dtype, shape and bytes, key-sorted:
    the integrity tag :func:`load_index` verifies (the reference's,
    computed in the same order, so a file carries one checksum in both
    packages). Not cryptographic: it catches truncated or garbled files."""
    crc = 0
    for name in sorted(arrays):
        a = np.ascontiguousarray(arrays[name])
        hdr = f"{name}:{a.dtype.str}:{a.shape}".encode()
        crc = zlib.crc32(a.tobytes(), zlib.crc32(hdr, crc))
    return crc


def _verify_snapshot(arrays: dict, source) -> dict:
    """Check a snapshot's ``checksum`` and ``version`` where present and
    return the arrays without the checksum. Raises ``ValueError`` with the
    reference's messages on a mismatch: a half-written snapshot must not
    serve wrong results."""
    arrays = dict(arrays)
    if "checksum" in arrays:
        stored = int(arrays.pop("checksum"))
        actual = snapshot_checksum(arrays)
        if actual != stored:
            raise ValueError(
                f"index snapshot {source!r} failed its integrity check "
                f"(stored crc32 {stored:#010x}, recomputed {actual:#010x}) "
                "— refusing to serve from a corrupt/truncated snapshot")
    if "version" in arrays:
        version = int(arrays["version"])
        if version != INDEX_SNAPSHOT_VERSION:
            raise ValueError(f"index snapshot {source!r} has version "
                             f"{version}; this build reads "
                             f"{INDEX_SNAPSHOT_VERSION}")
    return arrays


def save_index(index: CorpusIndex, path) -> None:
    """Persist a :class:`CorpusIndex` to one ``.npz`` file: the host
    arrays under the reference's keys and with its dtypes (idx int32,
    val/vecs/centroids/centers/pivots fp32, c_assign/c_order/ext_ids/remap
    int32, c_starts int64, c_radii fp64, n_groups and version int64),
    tagged with :func:`snapshot_checksum`. Everything else (the device
    uploads, norms, the nnz group split) is a pure function of these and
    is recomputed on load. A file of an index carried over from the
    reference (:func:`index_from_arrays`) equals the reference's, array
    for array, checksum included."""
    def f32(t):
        return np.ascontiguousarray(_host(t), np.float32)

    arrays = {
        "idx": np.ascontiguousarray(index.docs_host.idx, np.int32),
        "val": np.ascontiguousarray(index.docs_host.val, np.float32),
        "vecs": f32(index.vecs),
        "centroids": f32(index.centroids),
        "n_groups": np.asarray(len(index.groups), np.int64),
        "version": np.asarray(INDEX_SNAPSHOT_VERSION, np.int64),
    }
    cl = index.clusters
    if cl is not None:
        arrays["c_centers"] = f32(cl.centers)
        arrays["c_assign"] = np.asarray(cl.assign, np.int32)
        arrays["c_order"] = np.asarray(cl.order, np.int32)
        arrays["c_starts"] = np.asarray(cl.starts, np.int64)
        arrays["c_radii"] = np.asarray(cl.radii, np.float64)
    if index.ext_ids is not None:
        arrays["ext_ids"] = np.asarray(index.ext_ids, np.int32)
        arrays["remap"] = np.asarray(index.remap, np.int32)
    if index.pivots is not None:
        arrays["pivots"] = f32(index.pivots)
        arrays["doc_pivot_d"] = f32(index.doc_pivot_d)
    # the checksum covers everything above
    arrays["checksum"] = np.asarray(snapshot_checksum(arrays), np.uint32)
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def load_index(path, device=None) -> CorpusIndex:
    """Rebuild a :class:`CorpusIndex` on ``device`` (``None`` -> ``cuda``)
    from a :func:`save_index` file, the reference's or the port's. Refuses
    a bad checksum or version (``ValueError``) before trusting anything;
    the rebuilt index is bit-compatible with the saved one."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    return index_from_arrays(arrays, device=device, source=path)


def index_from_arrays(arrays: dict, device=None,
                      source="<arrays>") -> CorpusIndex:
    """Rebuild a :class:`CorpusIndex` from the numpy arrays a
    ``save_index`` writes, the reference's or the port's (``idx``,
    ``val``, ``vecs``, ``centroids``, ``n_groups``, ``c_*``, ``ext_ids``,
    ``remap``, ``pivots``, ``doc_pivot_d``): the same storage order,
    groups and clustering, on ``device``. ``checksum`` and ``version`` are
    verified whenever present (``ValueError`` on a mismatch)."""
    arrays = _verify_snapshot(arrays, source)
    dev = resolve_device(device)

    def t(name):
        return torch.as_tensor(np.asarray(arrays[name], np.float32),
                               device=dev)

    clusters = None
    if "c_centers" in arrays:
        assign = np.asarray(arrays["c_assign"], np.int32)
        clusters = IvfClusters(
            centers=t("c_centers"), assign=assign,
            order=np.asarray(arrays["c_order"], np.int32),
            starts=np.asarray(arrays["c_starts"], np.int64),
            radii=np.asarray(arrays["c_radii"], np.float64),
            assign_dev=torch.as_tensor(assign, device=dev))
    ext_ids = remap = None
    if "ext_ids" in arrays:
        ext_ids = np.asarray(arrays["ext_ids"], np.int32)
        remap = np.asarray(arrays["remap"], np.int32)
    pivots = doc_pivot_d = None
    if "pivots" in arrays:
        pivots, doc_pivot_d = t("pivots"), t("doc_pivot_d")
    return _assemble(np.asarray(arrays["idx"]), np.asarray(arrays["val"]),
                     t("vecs"), t("centroids"), int(arrays["n_groups"]),
                     clusters, ext_ids, remap, pivots, doc_pivot_d)


def index_to_device(index: CorpusIndex, device) -> CorpusIndex:
    """The same index with every device tensor on ``device`` (the host
    mirrors stay on the host). A tensor already there is kept as it is,
    so on one device this copies nothing."""
    dev = torch.device(device)

    def put(t):
        return None if t is None else t.to(dev)

    groups = tuple(g._replace(docs=PaddedDocs(idx=put(g.docs.idx),
                                              val=put(g.docs.val)))
                   for g in index.groups)
    clusters = index.clusters
    if clusters is not None:
        clusters = clusters._replace(centers=put(clusters.centers),
                                     assign_dev=put(clusters.assign_dev))
    return index._replace(
        docs=PaddedDocs(idx=put(index.docs.idx), val=put(index.docs.val)),
        groups=groups, vecs=put(index.vecs), vecs_sq=put(index.vecs_sq),
        centroids=put(index.centroids), clusters=clusters,
        pivots=put(index.pivots), doc_pivot_d=put(index.doc_pivot_d))


def _pad_width(a, width: int):
    """Right-pad axis 1 with zeros; numpy in -> numpy out, tensor in ->
    tensor out."""
    if a.shape[1] >= width:
        return a
    if isinstance(a, torch.Tensor):
        return torch.nn.functional.pad(a, (0, width - a.shape[1]))
    return np.pad(a, ((0, 0), (0, width - a.shape[1])))


def append_docs(index: CorpusIndex, new_docs: PaddedDocs) -> CorpusIndex:
    """Streaming index update: add documents without a rebuild.

    New docs get ids ``[n_docs, n_docs + n_new)`` and join the group with
    the fewest members (widened only if they are longer than its trim);
    every other group is reused as it is. The device side is concatenated
    on the device and the host mirror on the host, so only the new docs
    cross. ``search``/``query_batch`` after an append equal a rebuild:
    per-doc solves are independent and grouping and ELL padding are inert.

    IVF clusters and pivots are frozen: each new doc goes to its nearest
    existing center, only the grown clusters' radii can expand, and only
    the new rows of the pivot table are computed. The grown group is
    re-sorted cluster-major. Exact search (``nprobe=None``) is unaffected;
    smaller-``nprobe`` recall degrades as far as the frozen centers drift
    from the grown corpus. Raises ``ValueError`` for word ids outside the
    index's vocabulary."""
    n_new = new_docs.idx.shape[0]
    if n_new == 0:
        return index
    new_idx, new_val = _compact_slots(new_docs)
    if int(new_idx.max(initial=0)) >= index.vocab_size:
        raise ValueError("new docs reference word ids outside the index "
                         f"vocabulary ({index.vocab_size})")
    nnz = (new_val > 0).sum(1)
    lg_new = max(1, int(nnz.max(initial=0)))
    new_idx, new_val = new_idx[:, :lg_new], new_val[:, :lg_new]
    n_old = index.n_docs
    dev = index.device

    def up(idx_np, val_np, width):
        return (torch.as_tensor(_pad_width(idx_np, width), dtype=torch.int64,
                                device=dev),
                torch.as_tensor(_pad_width(val_np, width), device=dev))

    width = max(index.docs.idx.shape[1], lg_new)
    new_idx_dev, new_val_dev = up(new_idx, new_val, width)
    docs = PaddedDocs(
        idx=torch.cat([_pad_width(index.docs.idx, width), new_idx_dev]),
        val=torch.cat([_pad_width(index.docs.val, width), new_val_dev]))
    docs_host = PaddedDocs(
        idx=np.concatenate([_pad_width(index.docs_host.idx, width),
                            _pad_width(new_idx, width)]),
        val=np.concatenate([_pad_width(index.docs_host.val, width),
                            _pad_width(new_val, width)]))

    cent_new = _doc_centroids(new_idx_dev[:, :lg_new],
                              new_val_dev[:, :lg_new], index.vecs)
    clusters = index.clusters
    assign = None
    if clusters is not None:
        assign_new = _assign_clusters(cent_new, clusters.centers).cpu() \
            .numpy().astype(np.int32)
        assign = np.concatenate([clusters.assign, assign_new])
        c_order, c_starts = _membership(assign, clusters.n_clusters)
        radii = clusters.radii.copy()
        np.maximum.at(radii, assign_new,
                      _member_dists(cent_new, clusters.centers, assign_new))
        clusters = clusters._replace(
            assign=assign, order=c_order, starts=c_starts, radii=radii,
            assign_dev=torch.as_tensor(assign, device=dev))

    # grow only the smallest group; all others are reused untouched
    gi = int(np.argmin([g.cols.shape[0] for g in index.groups]))
    grp = index.groups[gi]
    gw = max(grp.docs.idx.shape[1], lg_new)
    g_new_idx, g_new_val = up(new_idx, new_val, gw)
    g_idx = torch.cat([_pad_width(grp.docs.idx, gw), g_new_idx])
    g_val = torch.cat([_pad_width(grp.docs.val, gw), g_new_val])
    g_cols = np.concatenate([grp.cols,
                             np.arange(n_old, n_old + n_new, dtype=np.int32)])
    if assign is not None:
        # keep the grown group cluster-major: one device gather per append
        gorder = np.argsort(assign[g_cols], kind="stable")
        if not np.array_equal(gorder, np.arange(gorder.size)):
            gd = torch.as_tensor(gorder, device=dev)
            g_idx, g_val, g_cols = g_idx[gd], g_val[gd], g_cols[gorder]
    groups = tuple(DocGroup(docs=PaddedDocs(idx=g_idx, val=g_val),
                            cols=g_cols.astype(np.int32)) if i == gi else g
                   for i, g in enumerate(index.groups))

    tail_ids = np.arange(n_old, n_old + n_new, dtype=np.int32)
    ext_ids = (np.concatenate([index.ext_ids, tail_ids])
               if index.ext_ids is not None else None)
    remap = (np.concatenate([index.remap, tail_ids])
             if index.remap is not None else None)
    doc_pivot_d = index.doc_pivot_d
    if index.pivots is not None:
        doc_pivot_d = torch.cat([index.doc_pivot_d,
                                 _pivot_dists(cent_new, index.pivots)])
    return index._replace(
        docs=docs, groups=groups, docs_host=docs_host,
        centroids=torch.cat([index.centroids, cent_new]),
        clusters=clusters, ext_ids=ext_ids, remap=remap,
        doc_pivot_d=doc_pivot_d)


# ------------------------------------------------------------------ engine
def bucket_size(v_r: int, min_bucket: int = 8) -> int:
    """Smallest power-of-two bucket (>= min_bucket) holding v_r query rows."""
    b = max(1, int(min_bucket))
    while b < v_r:
        b *= 2
    return b


def _prepare_query(q, bucket: int, dtype=np.float32):
    """Host-side support selection + bucket padding for one query row."""
    q = np.asarray(q, dtype=np.float64).reshape(-1)
    idx = np.nonzero(q > 0)[0]
    v_r = idx.size
    if v_r > bucket:
        raise ValueError(f"query v_r={v_r} exceeds bucket {bucket}")
    sup = np.zeros(bucket, np.int64)
    sup[:v_r] = idx
    r = np.ones(bucket, dtype)                # pad rows carry r == 1
    r[:v_r] = (q[idx] / q[idx].sum()).astype(dtype)
    mask = np.zeros(bucket, dtype)
    mask[:v_r] = 1.0
    return sup, r, mask


def _stabilize_log_g(g: torch.Tensor):
    """Column-stabilize a gathered log-kernel tile (Q, N, L, B): subtract
    each (q, n, l) column's max over the query-word axis and exponentiate.
    Pad rows carry -inf and become exactly 0; a column with no live row
    (a filler query) gets shift 0 and stays all zero. Returns (G', shift),
    every live column's largest entry 1, so no K column can underflow."""
    shift = g.max(dim=-1).values                              # (Q, N, L)
    shift = torch.where(torch.isfinite(shift), shift,
                        torch.zeros_like(shift))
    gp = torch.where(torch.isfinite(g), torch.exp(g - shift[..., None]),
                     torch.zeros_like(g))
    return gp, shift


def _compute_kq(sup: torch.Tensor, mask: torch.Tensor, vecs: torch.Tensor,
                vecs_sq: torch.Tensor, lam: float, gemm: str = "fp32",
                log_domain: bool = False, with_m: bool = False):
    """Stacked cdist GEMM -> K for one query chunk of (Q, B) word ids.

    ``with_m=False`` (the kernel impl): one (Q*B, w) x (w, V)
    ``torch.matmul``, returning kq (Q, B, V), the layout K1's gather wants
    (the reference computes the transposed product and transposes back for
    its kernel). ``with_m=True`` (the einsum impl): the product runs
    through :func:`~.kcache.cdist_rows` in fixed panels of words, the path
    the K-column cache shares bit for bit, and the pair (kq, mq) comes back
    in the reference's (Q, V, B) layout: K and the raw distances, which
    the einsum solve's distance line gathers (``mq`` unmasked).

    Pad rows (mask == 0) come out as all-zero K rows, or -inf rows of log K
    under ``log_domain``. ``gemm="bf16"`` rounds both operands of the
    product to bf16 (:func:`~.sinkhorn.gemm_round`); the product's sums and
    the norms stay fp32."""
    q, b = sup.shape
    a = vecs[sup].reshape(q * b, -1)                     # (Q*B, w)
    if with_m:
        m = cdist_rows(a, vecs, vecs_sq, gemm)           # (Q*B, V)
        m = m.reshape(q, b, -1).transpose(1, 2).contiguous()   # (Q, V, B)
        return kq_from_m(m, mask, lam, log_domain), m
    a2 = (a * a).sum(-1)                                 # (Q*B,)
    gd = torch.bfloat16 if gemm == "bf16" else None
    ab = torch.matmul(gemm_round(a, gd), gemm_round(vecs, gd).T)  # (Q*B, V)
    m = torch.sqrt(torch.clamp(a2[:, None] + vecs_sq[None, :] - 2.0 * ab,
                               min=0.0))
    live = mask.reshape(-1, 1) > 0
    if log_domain:
        k = torch.where(live, -lam * m, torch.full_like(m, -float("inf")))
    else:
        k = torch.exp(-lam * m) * live.to(m.dtype)
    return k.reshape(q, b, -1)


def _gather_g(kq: torch.Tensor, idx: torch.Tensor,
              layout: str = "qbnl") -> torch.Tensor:
    """Gather doc-word columns of K for a doc group's (N, L) word ids.
    ``"qbnl"``: kq (Q, B, V) -> G (Q, B, N, L), one doc's (B, L) tile per
    (query, doc), what K1 reads. ``"qnlb"``: kq (Q, V, B) -> G (Q, N, L,
    B), query rows on the minor axis, what the einsum solve reads."""
    if layout == "qnlb":
        return kq[:, idx]
    q, b, _ = kq.shape
    return gather_columns(kq.reshape(q * b, -1), idx).reshape(
        q, b, *idx.shape)


def _solve_batched_einsum(g, mq, idx, val, r, mask, lam: float, n_iter: int,
                          tol=None, check_every: int = 4, gemm: str = "fp32",
                          log_domain: bool = False, scope: str = "chunk",
                          qdoc_mask=None, x0q=None,
                          with_profile: bool = False, prof_mask=None):
    """The batched ELL Sinkhorn solve and distance line in plain torch (the
    reference's einsum impl).

    g (Q, N, L, B) gathered K (log K under ``log_domain``), query rows on
    the minor axis; mq (Q, V, B) the chunk's raw distances; idx, val (N,
    L); r, mask (Q, B). Pad rows (G == 0, r == 1) are inert. One G only:
    diag(1/r) is folded into the x update. Per iteration u = 1/x, t =
    sum_b G u (SDDMM), w = val/t on live slots, x = (sum_l G w) / r (SpMM).
    The linear domain keeps the raw val/t, so an underflowed K column
    turns the distance NaN (the engine's :class:`LamUnderflowError`); the
    log domain stabilizes G per column (:func:`_stabilize_log_g`) and
    guards t > 0, so a fully underflowed query-word row drops out.

    ``gemm="bf16"`` rounds G (once) and u and w (as operands) to bf16 and
    back, and contracts in fp32: ``torch.einsum`` on bf16 tensors would
    round its output too, where the reference keeps fp32 products and
    sums.

    ``tol`` runs the adaptive loop, ``n_iter`` as its cap: ``scope="chunk"``
    one exit for the chunk (:func:`~.sinkhorn_sparse.adaptive_loop`),
    ``scope="query"`` one per query, over its own live slots narrowed by
    ``qdoc_mask`` (Q, N) to its candidate docs, with converged queries
    frozen (:func:`~.sinkhorn_sparse.adaptive_loop_scoped`). ``x0q`` (Q,
    B) warm-starts every doc column from a per-query profile;
    ``with_profile`` also returns that profile of this solve: the
    doc-mean of the final x over ``prof_mask`` docs (else ``qdoc_mask``,
    else every live doc).

    The distance line gathers the true M from ``mq`` (no GM rebuilt from
    log G): sum_b u sum_l G M w, exact for the stabilized G too.

    Returns (wmd (Q, N), iters, [profile (Q, B)]): iters is the realized
    count, a Python int, or a (Q,) int32 tensor under ``scope="query"``."""
    q, n, _, b = g.shape
    live = val > 0                                         # (N, L)
    if log_domain:
        g, _ = _stabilize_log_g(g)
    gd = torch.bfloat16 if gemm == "bf16" else None
    gb = gemm_round(g, gd)

    def _sddmm(u):
        return torch.einsum("qnlb,qnb->qnl", gb, gemm_round(u, gd))

    def _spmm(w):
        return torch.einsum("qnlb,qnl->qnb", gb, gemm_round(w, gd))

    rinv = _inv(r, True)[:, None, :]                       # (Q, 1, B)
    if x0q is None:
        denom = mask.sum(dim=1, keepdim=True)
        x0 = torch.where(mask > 0, 1.0 / torch.clamp(denom, min=1.0), 0.0)
    else:
        # a warm profile carries mass only on the query's live words
        x0 = torch.where(mask > 0, x0q, 0.0)
    x = x0[:, None, :].expand(q, n, b).to(torch.float32).contiguous()

    def _select_w(t):
        return _select(live[None], val[None], t, log_domain)

    def step(x, active=None):
        # pad rows keep x == 0 (their G is 0), so one x > 0 guard on u
        u = _inv(x, True)
        if active is not None:
            # frozen queries' rows drop out: their u rows are zeroed
            u = u * active[:, None, None]
        w = _select_w(_sddmm(u))
        return _spmm(w) * rinv, w

    if tol is None:
        for _ in range(n_iter):
            x, _ = step(x)
        iters = int(n_iter)
    elif scope == "chunk":
        # live queries x live slots: fillers' w is inf/NaN and pad docs'
        # 0; neither may hold the loop open or close it
        resmask = (mask.sum(dim=1) > 0)[:, None, None] & live[None]
        x, iters = adaptive_loop(
            step, lambda w, wp: marginal_residual(w, wp, resmask),
            x, n_iter, tol, check_every)
    else:
        live_q = mask.sum(dim=1) > 0                       # (Q,)
        resmask = live_q[:, None, None] & live[None]       # (Q, N, L)
        if qdoc_mask is not None:
            resmask = resmask & qdoc_mask[:, :, None]
        x, iters = adaptive_loop_scoped(
            step, lambda w, wp: marginal_residual_per_query(w, wp, resmask),
            x, n_iter, tol, check_every, live_q)

    u = _inv(x, True)
    w = _select_w(_sddmm(u))
    mg = mq[:, idx]                                        # (Q, N, L, B)
    gm = torch.where(g > 0, g * mg, 0.0)
    wmd = torch.einsum("qnb,qnlb,qnl->qn", u, gm, w)
    if not with_profile:
        return wmd, iters
    # the per-query doc-mean of the converged x over the query's own
    # candidates: the chunk union holds other queries' seeds, whose far
    # columns would pull the profile to another scale
    doc_live = val.sum(dim=1) > 0                          # (N,)
    sel = prof_mask if prof_mask is not None else qdoc_mask
    pmask = doc_live[None] if sel is None else sel & doc_live[None]
    pmask = pmask.to(x.dtype).expand(q, n)
    cnt = torch.clamp(pmask.sum(dim=1), min=1.0)
    xprof = torch.einsum("qnb,qn->qb", x, pmask) / cnt[:, None]
    return wmd, iters, xprof


class SearchResult(NamedTuple):
    """Top-k retrieval result from :meth:`WmdEngine.search`. Rows for
    empty queries hold ``indices == -1`` and NaN distances; ``solved``
    counts the documents that went through the exact solve per query."""

    indices: np.ndarray    # (Q, k) int32 doc ids, ascending distance
    distances: np.ndarray  # (Q, k)
    solved: np.ndarray     # (Q,) int64 exact solves per query


ENGINE_IMPLS = ("sparse", "kernel")


class WmdEngine:
    """Persistent multi-query WMD engine over a frozen :class:`CorpusIndex`.
    Runs on the index's device.

    Parameters are the reference's: ``lam``/``n_iter`` (Sinkhorn strength
    and iteration count), ``impl`` (``"kernel"``: the Hopper solver K1;
    ``"sparse"``: the batched einsum solve), ``min_bucket``, ``max_batch``
    (queries per solve chunk), ``pad_q`` (round a chunk's Q up to a power
    of two with inert fillers), ``prune_slack`` (relative fp margin on the
    prune threshold) and ``precision`` (``"fp32"``, ``"bf16"``, ``"log"``,
    ``"bf16+log"``: bf16 operands with fp32 sums in the K block GEMM and
    the solve, and/or the underflow-free log domain). The default impl is
    ``"kernel"``, the card's path; the reference defaults to its einsum
    impl ``"sparse"``, which the port runs on request.

    ``tol`` switches to the adaptive solve: ``n_iter`` becomes a cap, and
    the solve checks every ``check_every`` iterations whether the
    doc-marginal residual (relative to each doc's own scale) is at most
    ``tol``; realized counts land on ``1 + k*check_every``. K1 exits per
    document; the einsum solve per chunk or per query (see ``scope``).
    ``scope="query"`` (the default) narrows each query's exit test in
    :meth:`search`'s survivor and refine solves to its own candidates (a
    survivor outside the scope stops at the first check: its bound keeps
    it above the threshold at any truncation) and records one realized
    count per live query; ``scope="chunk"`` tests every doc and records
    one count per dispatch. ``warm_start`` (with ``tol``, on
    ``impl="sparse"``) starts survivor solves from the seed solve's
    converged per-query profile; it is inert without ``tol`` and on the
    kernel impl, as in the reference. Realized counts:
    :meth:`iter_stats`, kept in a ring of ``iter_stats_maxlen``
    dispatches.

    ``kcache_slots`` (``impl="sparse"`` only, ``ValueError`` on the kernel
    impl) keeps that many words' (V,) distance rows on the device across
    calls (:mod:`.kcache`); chunks with fewer than ``kcache_min_hits``
    resident words take the stacked GEMM and warm the cache. Results equal
    the uncached engine's bit for bit.
    """

    def __init__(self, index: CorpusIndex, lam: float = 10.0,
                 n_iter: int = 15, impl: str = "kernel",
                 min_bucket: int = 8, max_batch: int = 4,
                 pad_q: bool = True, prune_slack: float = 1e-3,
                 tol: float | None = None, check_every: int = 4,
                 precision=None, scope: str = "query",
                 warm_start: bool = False, iter_stats_maxlen: int = 4096,
                 kcache_slots: int | None = None,
                 kcache_min_hits: int = 4):
        if impl not in ENGINE_IMPLS:
            raise ValueError(f"impl must be one of {ENGINE_IMPLS}, "
                             f"got {impl!r}")
        if scope not in ("chunk", "query"):
            raise ValueError(f"scope must be 'chunk' or 'query', "
                             f"got {scope!r}")
        if tol is not None and int(check_every) < 1:
            raise ValueError(f"check_every must be >= 1, got {check_every}")
        if kcache_slots and impl == "kernel":
            raise ValueError(
                "kcache_slots needs impl='sparse': the kernel impl's K "
                "block carries no distance block to warm the cache from")
        self.precision = SolvePrecision.parse(precision)
        self.index = index
        self.device = index.device
        self.lam = float(lam)
        self.n_iter = int(n_iter)
        self.impl = impl
        self.min_bucket = int(min_bucket)
        self.max_batch = int(max_batch)
        self.pad_q = bool(pad_q)
        self.prune_slack = float(prune_slack)
        self.tol = None if tol is None else float(tol)
        self.check_every = int(check_every)
        self.scope = scope
        self.warm_start = bool(warm_start)
        self.dtype = np.dtype(np.float32)
        # bounded ring of (stage, iters, per_query, n_live) dispatch
        # records; iters stays on the device until iter_stats reads it
        self._iters_pending = collections.deque(
            maxlen=max(1, int(iter_stats_maxlen)))
        self._iters_dropped = 0
        self._kcache = None
        self.kcache_min_hits = max(1, int(kcache_min_hits))
        # (index, {id(whole-corpus group): live words}) for the solve span
        self._group_words = (None, {})
        if kcache_slots:
            self.enable_kcache(int(kcache_slots))

    # ------------------------------------------------- cross-request cache
    def enable_kcache(self, slots: int) -> bool:
        """Attach a :class:`~.kcache.KCache` of ``slots`` resident rows
        (replacing any cache). Returns ``False``, attaching nothing, on the
        kernel impl."""
        if self.impl == "kernel":
            return False
        from .kcache import KCache
        self._kcache = KCache(self.index.vecs, self.index.vecs_sq,
                              int(slots), gemm=self.precision.gemm)
        return True

    def kcache_stats(self) -> dict | None:
        """The cache's counters (:meth:`~.kcache.KCache.stats`), ``None``
        without a cache."""
        return None if self._kcache is None else self._kcache.stats()

    def reset_kcache_stats(self) -> None:
        if self._kcache is not None:
            self._kcache.reset_counters()

    # -------------------------------------------------- realized iterations
    def reset_iter_stats(self) -> None:
        """Drop the realized-iteration log and the dropped-record count."""
        self._iters_pending.clear()
        self._iters_dropped = 0

    @property
    def iter_stats_dropped(self) -> int:
        """Dispatch records the bounded ring discarded since the last
        :meth:`reset_iter_stats`: nonzero means :meth:`iter_stats` is a
        window over the most recent ``iter_stats_maxlen`` dispatches."""
        return self._iters_dropped

    def _record_iters(self, stage: str, iters,
                      per_query: bool, n_live: int) -> None:
        """Log one dispatch's realized counts, unsynced: K1's (Qp, blocks)
        tensor, the einsum solve's (Qp,) tensor or its int.
        :meth:`iter_stats` reduces them to one count per live query
        (``per_query``) or one per dispatch."""
        if len(self._iters_pending) == self._iters_pending.maxlen:
            self._iters_dropped += 1    # ring full: the oldest goes
        self._iters_pending.append((stage, torch.as_tensor(iters), per_query,
                                    n_live))

    def iter_stats(self, stage: str | None = None) -> np.ndarray:
        """Realized Sinkhorn iteration counts since the last
        :meth:`reset_iter_stats` (the device values are read here, not on
        the hot path). A query's count in a dispatch is the largest of its
        docs'. Per-query dispatches (``scope="query"`` with ``tol``) give
        one entry per live query; the others give the dispatch's largest
        count once per live query, so both count iterations per query.
        With ``tol=None`` every entry is ``n_iter``. ``stage`` keeps one
        solve stage: ``"batch"`` (:meth:`query_batch`), ``"seed"``,
        ``"survivor"`` or ``"refine"`` (:meth:`search`)."""
        out = []
        for st, iters, per_query, n_live in self._iters_pending:
            if stage is not None and st != stage:
                continue
            if per_query:
                arr = iters.reshape(iters.shape[0], -1).max(dim=1).values
                arr = arr.cpu().numpy()[:n_live]
            else:
                arr = np.full(n_live, int(iters.max()))
            out.append(arr.astype(np.int64))
        if not out:
            return np.zeros((0,), np.int64)
        return np.concatenate(out)

    def iter_stats_by_stage(self) -> dict:
        """:meth:`iter_stats` split by solve stage, in first-seen order."""
        stages = []
        for st, *_ in self._iters_pending:
            if st not in stages:
                stages.append(st)
        return {st: self.iter_stats(stage=st) for st in stages}

    def _scoped(self) -> bool:
        """Per-query residual scoping active for this engine's solves?"""
        return self.tol is not None and self.scope == "query"

    def _ext(self, storage_ids) -> np.ndarray:
        return self.index.to_external(np.asarray(storage_ids))

    def query(self, r_full) -> torch.Tensor:
        """WMD from one full-vocab query histogram to every doc: (N,)."""
        return self.query_batch([r_full])[0]

    # ------------------------------------------------------------ staging
    def _plan(self, queries: list):
        """Bucket + chunk the query set: (v_r per query, [(positions,
        width), ...]). Queries are grouped into power-of-two v_r buckets,
        sorted by v_r inside each, chunked by ``max_batch`` and each chunk
        trimmed to the smallest multiple of 8 covering its members; empty
        queries are left out."""
        with trace.span("wmd.plan"):
            vr = [int((q > 0).sum()) for q in queries]
            buckets: dict[int, list[int]] = {}
            for qi in range(len(queries)):
                if vr[qi] == 0:
                    continue        # empty marginal: NaN row, never solved
                buckets.setdefault(bucket_size(vr[qi], self.min_bucket),
                                   []).append(qi)
            chunks = []
            for b in sorted(buckets):
                members = sorted(buckets[b], key=lambda qi: vr[qi])
                for lo in range(0, len(members), self.max_batch):
                    chunk = members[lo:lo + self.max_batch]
                    width = max(8, min(b, -(-max(vr[qi] for qi in chunk)
                                             // 8) * 8))
                    chunks.append((chunk, width))
            return vr, chunks

    def _prep_chunk(self, chunk_queries: list, width: int):
        """Stage one chunk: (sup, r, mask) device tensors, q-padded to a
        power of two with inert fillers when ``pad_q``."""
        with trace.span("wmd.stage") as s:
            prepared = [_prepare_query(q, width, self.dtype)
                        for q in chunk_queries]
            n_live = len(prepared)
            q_pad = n_live
            if self.pad_q:
                q_pad = 1
                while q_pad < n_live:
                    q_pad *= 2
            filler = (np.zeros(width, np.int64), np.ones(width, self.dtype),
                      np.zeros(width, self.dtype))
            prepared += [filler] * (q_pad - n_live)
            staged = [np.stack([p[i] for p in prepared]) for i in range(3)]
            if s:
                trace.add("h2d_pageable_bytes", sum(a.nbytes for a in staged))
            dev = self.device
            return tuple(torch.as_tensor(a, device=dev) for a in staged)

    def _kq(self, sup, mask):
        """The chunk's K block as the pair (kq, mq): the kernel impl's
        (Q, B, V) K with ``mq=None`` (K1 rebuilds GM from G), the einsum
        impl's (Q, V, B) K and raw distances. With a cache attached
        (:meth:`enable_kcache`), a chunk with at least ``kcache_min_hits``
        resident words is assembled from cached rows and a misses-only
        GEMM; a chunk below that, or with more unique words than slots,
        takes the stacked GEMM and warms the cache from its distances. Both
        give the same bits. Looking the words up reads ``sup`` back to the
        host (one sync per chunk with a cache)."""
        with trace.span("wmd.kblock"):
            index = self.index
            if self.impl == "kernel":
                return _compute_kq(sup, mask, index.vecs, index.vecs_sq,
                                   self.lam, gemm=self.precision.gemm,
                                   log_domain=self.precision.log_domain), None
            cache = self._kcache
            if cache is not None and cache.vecs is not index.vecs:
                # another embedding table (a new index) drops every row;
                # append_docs keeps vecs, and with it the cache
                cache = self._kcache = cache.rebind(index.vecs, index.vecs_sq)

            def stacked():
                return _compute_kq(sup, mask, index.vecs, index.vecs_sq,
                                   self.lam, gemm=self.precision.gemm,
                                   log_domain=self.precision.log_domain,
                                   with_m=True)

            if cache is None:
                return stacked()
            sup_np = sup.cpu().numpy()
            ids = np.unique(sup_np.reshape(-1))
            n_hit = cache.lookup(ids)
            oversize = len(ids) > cache.slots
            if oversize or n_hit < self.kcache_min_hits:
                cache.note_fallback(oversize=oversize)
                kq, mq = stacked()
                cache.warm(sup_np, mq)
                return kq, mq
            from .kcache import assemble_kq
            return assemble_kq(cache.rows(ids), np.searchsorted(ids, sup_np),
                               mask, self.lam,
                               log_domain=self.precision.log_domain)

    def _solve_group(self, kq, r, mask, grp: DocGroup, n_live: int,
                     stage: str = "batch", qdoc_mask=None, x0q=None,
                     want_profile: bool = False, prof_mask=None):
        """Solve one staged chunk against one doc group (a device tensor
        (Qp, N_g), not synced): gather the group's K columns and solve, by
        one launch of K1 or the einsum solve. ``kq`` is the pair from
        :meth:`_kq`. The realized counts go to :meth:`iter_stats` under
        ``stage``. ``qdoc_mask`` (Qp, N_g) bool scopes each query's
        adaptive exit to its own candidate docs (``scope="query"``).
        ``x0q`` (Qp, B) warm-starts the einsum solve; ``want_profile``
        returns ``(wmd, profile)``, its converged profile averaged over
        ``prof_mask`` docs (``None`` on the kernel impl)."""
        with trace.span("wmd.solve") as s:
            if s:
                n_pad, l_g = grp.docs.idx.shape
                s.set(docs=len(grp.cols), doc_words=self._live_words(grp),
                      n_pad=n_pad, l_g=l_g, stage=stage)
            kqk, mq = kq
            scoped = self._scoped()
            if self.impl == "kernel":
                from repro_torch.kernels.ops import sinkhorn_fused_all_batched
                g = _gather_g(kqk, grp.docs.idx)
                wmd, iters = sinkhorn_fused_all_batched(
                    g, grp.docs.val, r, self.lam, self.n_iter, tol=self.tol,
                    check_every=self.check_every, gemm=self.precision.gemm,
                    log_domain=self.precision.log_domain,
                    resmask=qdoc_mask if scoped else None, with_iters=True)
                self._record_iters(stage, iters, scoped, n_live)
                return (wmd, None) if want_profile else wmd
            out = _solve_batched_einsum(
                _gather_g(kqk, grp.docs.idx, layout="qnlb"), mq,
                grp.docs.idx, grp.docs.val, r, mask, self.lam, self.n_iter,
                tol=self.tol, check_every=self.check_every,
                gemm=self.precision.gemm,
                log_domain=self.precision.log_domain, scope=self.scope,
                qdoc_mask=qdoc_mask if scoped else None, x0q=x0q,
                with_profile=want_profile, prof_mask=prof_mask)
            self._record_iters(stage, out[1], scoped, n_live)
            return (out[0], out[2]) if want_profile else out[0]

    def _live_words(self, grp: DocGroup) -> int:
        """Live words of the group's real documents, from the host mirror
        (read while tracing only); a whole-corpus group's once."""
        index = self.index
        if self._group_words[0] is not index:
            self._group_words = (index, {})
        whole = self._group_words[1]
        if id(grp) in whole:
            return whole[id(grp)]
        n = int(np.count_nonzero(index.docs_host.val[grp.cols] > 0))
        if any(grp is g for g in index.groups):
            whole[id(grp)] = n
        return n

    def _warm(self) -> bool:
        """Do survivor solves start from the seed solve's profile?"""
        return self.impl == "sparse" and self.warm_start \
            and self.tol is not None

    def _raise_if_nan(self, wmd_np: np.ndarray, chunk_queries: list) -> None:
        """Every chunk query has support, so NaN here means the lam-driven
        K underflow — diagnose (host-side, error path only) and raise."""
        bad = np.isnan(wmd_np).any(axis=1)
        if bad.any():
            q = chunk_queries[int(np.nonzero(bad)[0][0])]
            _, vecs_sel, _ = select_support(q, self.index.vecs)
            raise LamUnderflowError(underflow_report(
                self.lam, vecs_sel, self.index.vecs, self.index.docs))

    # ----------------------------------------------------------- scoring
    def query_batch(self, queries: Sequence) -> torch.Tensor:
        """Exhaustive WMD for Q queries (full-vocab histogram rows) ->
        (Q, N) host tensor in the caller's doc order. A query with no
        support yields a NaN row. Raises :class:`LamUnderflowError` if lam
        underflows K for a corpus word."""
        with trace.span("wmd.batch"):
            queries = [np.asarray(q) for q in queries]
            if not queries:
                return torch.zeros((0, self.index.n_docs))
            vr, chunks = self._plan(queries)
            # launch every chunk before collecting any result: the device
            # runs chunk i while the host stages chunk i+1
            pending = []
            for chunk, width in chunks:
                with trace.span("wmd.chunk") as c:
                    sup, r, mask = self._prep_chunk(
                        [queries[qi] for qi in chunk], width)
                    if c:
                        _chunk_attrs(c, chunk, vr, width, r)
                    kq = self._kq(sup, mask)
                    pending.append((chunk, [
                        (grp, self._solve_group(kq, r, mask, grp, len(chunk)))
                        for grp in self.index.groups]))
            with trace.span("wmd.collect"):
                out = np.zeros((len(queries), self.index.n_docs), self.dtype)
                for qi in range(len(queries)):
                    if vr[qi] == 0:
                        out[qi] = np.nan
                for chunk, parts in pending:
                    for grp, wmd_g in parts:
                        w = _read(wmd_g[:len(chunk)])
                        self._raise_if_nan(w, [queries[qi] for qi in chunk])
                        out[np.ix_(chunk, self._ext(grp.cols))] = w
            return torch.from_numpy(out)

    # ------------------------------------------------------------ search
    def search(self, queries: Sequence, k: int, prune: object = "rwmd",
               nprobe: int | None = None, mode: str = "exact",
               refine_factor: int = 4) -> SearchResult:
        """Staged top-k retrieval: prune -> solve -> rank.

        ``prune=None`` scores exhaustively (:meth:`query_batch` + stable
        argsort). Otherwise ``prune`` names a lower bound (``"wcd"``,
        ``"rwmd"``, ``"wcd+rwmd"``, a cascade ``"ivf[+pivot][+wcd][+rwmd]"``)
        or is a :class:`~repro_torch.core.prune.Pruner` /
        :class:`~repro_torch.core.prune.CascadePruner` instance.

        ``mode="exact"``: admissible bounds (a full sweep per chunk, or the
        cascade's shrinking candidate set over the ``nprobe`` nearest
        clusters per query, ``None`` = all); an exact solve of the union of
        each query's k best-bounded docs, whose kth distance is the query's
        threshold; an exact solve of the docs whose bound passes it (+
        ``prune_slack``); a rank over the solved docs. With an RWMD stage
        and every cluster probed the result equals the exhaustive top-k (up
        to tie order). A cascade at ``nprobe < n_clusters`` is approximate:
        un-probed clusters are never scored, recall is monotone in
        ``nprobe``, and a query with fewer than k reachable candidates pads
        its row with -1 / NaN.

        ``mode="refine"`` ranks every candidate by the pruner's tightest
        bound and solves only each query's best ``refine_factor * k``; each
        query is ranked over its own picks, so recall is monotone in
        ``refine_factor``, every returned distance is exact, and at a
        factor covering the candidate universe the result equals
        ``mode="exact"``. ``solved`` is then each query's own pick count.

        Raises ``ValueError`` for ``k <= 0``, an unknown ``mode`` or spec,
        ``refine_factor < 1``, or ``mode="refine"`` with ``prune=None``;
        :class:`LamUnderflowError` when ``exp(-lam*M)`` underflows for a
        solved pair."""
        with trace.span("wmd.search"):
            queries = [np.asarray(q) for q in queries]
            n = self.index.n_docs
            if k <= 0:
                raise ValueError(f"k must be positive, got {k}")
            if mode not in ("exact", "refine"):
                raise ValueError(f"mode must be 'exact' or 'refine', "
                                 f"got {mode!r}")
            if mode == "refine":
                if prune is None:
                    raise ValueError(
                        "mode='refine' ranks candidates by a pruner's lower "
                        "bound; prune=None has no bound to rank by — use "
                        "mode='exact' for the exhaustive path")
                if int(refine_factor) < 1:
                    raise ValueError(f"refine_factor must be >= 1, "
                                     f"got {refine_factor}")
            k = min(int(k), n)
            nq = len(queries)
            out_i = np.full((nq, k), -1, np.int32)
            out_d = np.full((nq, k), np.nan, self.dtype)
            solved = np.zeros(nq, np.int64)
            if nq == 0 or n == 0:
                return SearchResult(out_i, out_d, solved)

            if prune is None:
                d = self.query_batch(queries).numpy()
                with trace.span("wmd.rank"):
                    for qi in range(nq):
                        if np.isnan(d[qi]).all():
                            continue                      # empty marginal
                        order = np.argsort(d[qi], kind="stable")[:k]
                        out_i[qi], out_d[qi] = order, d[qi, order]
                        solved[qi] = n
                return SearchResult(out_i, out_d, solved)

            from .prune import CascadePruner, resolve_pruner
            pruner = resolve_pruner(prune, nprobe=nprobe)
            vr, chunks = self._plan(queries)
            if mode == "refine":
                if chunks:
                    self._search_refine(queries, k, pruner, nprobe, chunks,
                                        int(refine_factor), out_i, out_d,
                                        solved)
                return SearchResult(out_i, out_d, solved)
            if isinstance(pruner, CascadePruner):
                if chunks:
                    self._search_cascade(queries, k, pruner, nprobe, chunks,
                                         out_i, out_d, solved)
                return SearchResult(out_i, out_d, solved)
            for chunk, width in chunks:
                with trace.span("wmd.chunk") as c:
                    cq = [queries[qi] for qi in chunk]
                    qc = len(chunk)
                    sup, r, mask = self._prep_chunk(cq, width)
                    if c:
                        _chunk_attrs(c, chunk, vr, width, r)
                    kq = self._kq(sup, mask)      # shared by both solves

                    def solve(doc_ids, qmask=None, stage="seed", warm=None,
                              prof=None):
                        # -> ((qc, |ids|) host array, NaN-checked; warm
                        # profile)
                        grp = self.index.subset(doc_ids, storage=True)
                        n_pad = grp.docs.idx.shape[0]
                        qm = (None if qmask is None else self._pad_qdoc(
                            qmask, r.shape[0], n_pad))
                        pm = (None if prof is None else self._pad_qdoc(
                            prof, r.shape[0], n_pad))
                        want = self._warm()
                        out = self._solve_group(kq, r, mask, grp, qc, stage,
                                                qm, x0q=warm,
                                                want_profile=want,
                                                prof_mask=pm)
                        w, prof_out = out if want else (out, None)
                        w = _read(w[:qc, :doc_ids.size])
                        self._raise_if_nan(w, cq)
                        return w, prof_out

                    cand, d_cand = self._prune_full(pruner, sup, r, mask, qc,
                                                    k, solve)
                    with trace.span("wmd.rank"):
                        cand_ext = self._ext(cand)  # storage -> caller ids
                        for ci, qi in enumerate(chunk):
                            order = np.argsort(d_cand[ci], kind="stable")[:k]
                            out_i[qi, :order.size] = cand_ext[order]
                            out_d[qi, :order.size] = d_cand[ci, order]
                            solved[qi] = cand.size
            return SearchResult(out_i, out_d, solved)

    def _pad_qdoc(self, qmask, qp: int, n_pad: int) -> torch.Tensor:
        """A (qc, |ids|) per-query candidate mask (host array or device
        tensor) padded on the device to the solve's (Qp, N_pad) shape:
        fillers and pad docs are outside every scope."""
        out = torch.zeros((qp, n_pad), dtype=torch.bool, device=self.device)
        if isinstance(qmask, np.ndarray):
            trace.add("h2d_pageable_bytes", qmask.nbytes)
        out[:qmask.shape[0], :qmask.shape[1]] = torch.as_tensor(
            qmask, device=self.device)
        return out

    def _threshold(self, d_seed: torch.Tensor, k: int,
                   n_seed: int) -> torch.Tensor:
        """Pruning threshold: per-query kth-smallest exact distance among
        the solved seeds (+ fp slack margin); +inf with fewer than k."""
        if n_seed >= k:
            t = torch.sort(d_seed, dim=1).values[:, k - 1]
        else:
            t = torch.full((d_seed.shape[0],), float("inf"),
                           dtype=d_seed.dtype, device=d_seed.device)
        return t + self.prune_slack * (t.abs() + 1.0)

    def _prune_full(self, pruner, sup, r, mask, qc, k, solve):
        """Full-sweep prune stage: bounds for every doc, seed solve of each
        query's k best-bounded docs (chunk union), threshold, survivor
        solve. Seed picking and the threshold test run on the device; only
        compact id arrays cross to the host. Returns (candidate storage
        ids, (qc, |cand|) exact distances).

        With per-query scoping the seed solve's exit covers every seed (any
        chunkmate's seed can contend for any query's top-k once thresholds
        exist), and each query's survivor solve covers only the docs whose
        bound passed its own threshold: a survivor outside that scope stays
        out of its top-k at any truncation, since RWMD bounds the computed
        score from below. A query's own k picks drive only its warm-start
        profile (``warm_start`` on the einsum impl)."""
        from .prune import _keep_any
        with trace.span("wmd.bound"):
            lb = pruner.lower_bounds(self.index, sup, r, mask)   # (Qp, N)
        with trace.span("wmd.prune"):
            seed_pos = _read(torch.topk(-lb[:qc], k, dim=1).indices)
            seed = np.unique(seed_pos).astype(np.int32)
            qmask_seed = None
            if self._warm() and self._scoped():
                qmask_seed = np.stack([np.isin(seed, seed_pos[qi])
                                       for qi in range(qc)])
        d_seed, xprof = solve(seed, None, "seed", prof=qmask_seed)
        with trace.span("wmd.prune") as s:
            if s:
                trace.add("h2d_pageable_bytes", d_seed.nbytes)
            thresh = self._threshold(
                torch.as_tensor(d_seed, device=lb.device), k, seed.size)
            keep = _keep_any(lb, thresh)
            # nonzero syncs to size its output
            surv = _read(torch.nonzero(keep).flatten()).astype(np.int32)
            surv = surv[~np.isin(surv, seed)]
            cand = np.concatenate([seed, surv])
            if not surv.size:
                return cand, d_seed
            qmask_surv = None
            if self._scoped():
                surv_dev = torch.as_tensor(surv.astype(np.int64),
                                           device=lb.device)
                if s:
                    trace.add("h2d_pageable_bytes", surv.size * 8)
                qmask_surv = lb[:qc, surv_dev] <= thresh[:qc, None]
        d_surv, _ = solve(surv, qmask_surv, "survivor", warm=xprof)
        return cand, np.concatenate([d_seed, d_surv], axis=1)

    def _stage_all(self, queries, chunks):
        """Stage every live query once, at the widest chunk's width (the
        bound stages read the (Q, B) support arrays directly, so one prune
        pass covers the whole set): (live_q, sup, r, mask)."""
        live_q = [qi for chunk, _ in chunks for qi in chunk]
        width_g = max(width for _, width in chunks)
        return (live_q, *self._prep_chunk([queries[qi] for qi in live_q],
                                          width_g))

    def _make_solver(self, queries, chunks, live_q):
        """Stage every v_r chunk once (sup/r/mask and its K block) and
        return ``solve_all(doc_ids, qmask=None, stage="seed", warm=None,
        prof=None)``, the chunk-looped exact solve over one candidate id
        array shared by the cascade and refine searches: ((len(live_q),
        |ids|) host array with rows in ``live_q`` order, the per-chunk
        warm-start profiles). ``qmask`` (len(live_q), |ids|) bool, a host
        array or device tensor, is each query's residual scope under
        ``scope="query"``; ``prof`` the same for each query's profile;
        ``warm`` the per-chunk profiles to start from. Every chunk's solve
        is launched before the results come back in one copy; a NaN row
        raises :class:`LamUnderflowError`."""
        row_of = {qi: g for g, qi in enumerate(live_q)}
        prepped = []
        for chunk, width in chunks:
            cq = [queries[qi] for qi in chunk]
            sup, r, mask = self._prep_chunk(cq, width)
            prepped.append(([row_of[qi] for qi in chunk], cq, r, mask,
                            self._kq(sup, mask)))
        want = self._warm()

        def solve_all(doc_ids, qmask=None, stage="seed", warm=None,
                      prof=None):
            # one gather shared by the chunks; cascade ids are
            # cluster-sorted storage ids, a near-contiguous host slice
            grp = self.index.subset(doc_ids, storage=True)
            n_pad = grp.docs.idx.shape[0]
            parts, profs = [], []
            for ci, (rows, _, r, mask, kq) in enumerate(prepped):
                out = self._solve_group(
                    kq, r, mask, grp, len(rows), stage,
                    None if qmask is None else self._pad_qdoc(
                        qmask[rows], r.shape[0], n_pad),
                    x0q=None if warm is None else warm[ci],
                    want_profile=want,
                    prof_mask=None if prof is None else self._pad_qdoc(
                        prof[rows], r.shape[0], n_pad))
                w, xp = out if want else (out, None)
                parts.append(w[:len(rows), :doc_ids.size])
                profs.append(xp)
            w_all = torch.cat(parts).cpu().numpy()
            out = np.empty((len(live_q), doc_ids.size), self.dtype)
            lo = 0
            for rows, cq, *_ in prepped:
                w = w_all[lo:lo + len(rows)]
                lo += len(rows)
                self._raise_if_nan(w, cq)
                out[rows] = w
            return out, profs

        return solve_all

    def _search_refine(self, queries, k, pruner, nprobe, chunks,
                       refine_factor, out_i, out_d, solved):
        """Rank-then-refine (``mode="refine"``): one bound pass ranks the
        candidate universe, then one solve covers the union of each
        query's best ``k' = refine_factor * k`` picks. The ranking bound
        is a cascade's tightest (last) stage over the probed clusters'
        members, or a full-sweep pruner's own bound over every doc. Each
        query is ranked over its own picks only."""
        from .prune import CascadePruner, _pad_pow2_ids, _smallest
        index = self.index
        live_q, sup_g, r_g, mask_g = self._stage_all(queries, chunks)
        qg = len(live_q)
        if isinstance(pruner, CascadePruner):
            _, pm, qcent = pruner.probe(index, sup_g, r_g, mask_g, nprobe)
            # candidate universe = union of the probed clusters' members
            keep_c = (np.ones(index.clusters.n_clusters, bool) if pm is None
                      else pm[:qg].any(dim=0).cpu().numpy())
            cand = pruner.cluster_members(index, keep_c)
            if cand.size == 0:
                return
            sp = _pad_pow2_ids(cand)
            lb = pruner.stage_bounds(
                pruner.stages[-1], index, sup_g, r_g, mask_g, sp, cand.size,
                pruner.id_qmask(index, pm, sp, cand.size,
                                qp=sup_g.shape[0]), qcent=qcent)
        else:
            cand = np.arange(index.n_docs, dtype=np.int32)
            sp = cand
            lb = pruner.lower_bounds(index, sup_g, r_g, mask_g)
        kp = min(refine_factor * k, cand.size)
        vals, pos = _smallest(lb[:qg], kp)
        vals, pos = vals.cpu().numpy(), pos.cpu().numpy()
        # per-query own picks; +inf bounds are non-candidates (a query
        # whose probed universe holds fewer than k' docs)
        own = []
        for g in range(qg):
            p = pos[g][np.isfinite(vals[g])]
            p = p[p < cand.size]
            own.append(np.unique(sp[p]).astype(np.int32))
        ids = np.unique(np.concatenate(own))
        if ids.size == 0:
            return
        qmask_own = np.stack([np.isin(ids, o) for o in own])
        d, _ = self._make_solver(queries, chunks, live_q)(
            ids, qmask_own if self._scoped() else None, "refine")
        # rank each query over its own picks only, so the pick-set nesting
        # (and with it recall monotonicity) holds per query
        dm = np.where(qmask_own, d, np.inf)
        ids_ext = self._ext(ids)
        for g, qi in enumerate(live_q):
            n_own = int(qmask_own[g].sum())
            order = np.argsort(dm[g], kind="stable")[:min(k, n_own)]
            out_i[qi, :order.size] = ids_ext[order]
            out_d[qi, :order.size] = d[g, order]
            solved[qi] = n_own

    def _search_cascade(self, queries, k, pruner, nprobe, chunks,
                        out_i, out_d, solved):
        """The cascade driver, one prune pass for the whole query set:

        1. cluster probe and seed candidates from each query's nearest
           probed clusters (just enough to cover k docs);
        2. first-stage bounds on the seed candidates -> each query's best k
           -> exact seed solve (per solve chunk) -> threshold t_q (on the
           device);
        3. ``pruner.survivors``: the cluster-radius filter drops whole
           clusters, then the per-doc stages cheapest-first;
        4. exact solve of the survivors, rank.
        """
        from .prune import _pad_pow2_ids, _smallest
        index = self.index
        live_q, sup_g, r_g, mask_g = self._stage_all(queries, chunks)
        qg = len(live_q)
        cdists, pm, qcent = pruner.probe(index, sup_g, r_g, mask_g, nprobe)
        seed_cand = pruner.seed_candidates(index, cdists, mask_g, k, pm)
        if seed_cand.size == 0:
            return
        sp = _pad_pow2_ids(seed_cand)
        lb = pruner.stage_bounds(
            pruner.stages[0], index, sup_g, r_g, mask_g, sp, seed_cand.size,
            pruner.id_qmask(index, pm, sp, seed_cand.size,
                            qp=sup_g.shape[0]), qcent=qcent)
        vals, seed_pos = _smallest(lb[:qg], min(k, seed_cand.size))
        # +inf picks are non-candidates (a query with fewer candidates)
        pos_seed = torch.unique(seed_pos[torch.isfinite(vals)]).cpu().numpy()
        pos_seed = pos_seed[pos_seed < seed_cand.size]
        if pos_seed.size == 0:
            return
        seed = sp[pos_seed]
        qmask_seed = None
        if self._warm() and self._scoped():
            # each query's own finite top-k picks: its warm profile's docs
            vals_np, pos_np = vals.cpu().numpy(), seed_pos.cpu().numpy()
            qmask_seed = np.zeros((qg, seed.size), bool)
            for g in range(qg):
                own = pos_np[g][np.isfinite(vals_np[g])]
                own = own[own < seed_cand.size]
                qmask_seed[g] = np.isin(seed, sp[own])
        # the solve stays v_r-bucketed: per-chunk staging, reused for the
        # seed and survivor solves
        solve_all = self._make_solver(queries, chunks, live_q)
        d_seed, xprofs = solve_all(seed, prof=qmask_seed)
        thresh = self._threshold(torch.as_tensor(d_seed, device=self.device),
                                 k, seed.size)
        surv = pruner.survivors(index, sup_g, r_g, mask_g, cdists, pm,
                                qcent, thresh, exclude=seed)
        cand = np.concatenate([seed, surv])
        d_cand = d_seed
        if surv.size:
            qmask_surv = None
            if self._scoped():
                # each query's scope: the final survivors re-bounded by the
                # cascade's tightest stage (one more dispatch) against its
                # own threshold
                sps = _pad_pow2_ids(surv)
                lbs = pruner.stage_bounds(
                    pruner.stages[-1], index, sup_g, r_g, mask_g, sps,
                    surv.size,
                    pruner.id_qmask(index, pm, sps, surv.size,
                                    qp=sup_g.shape[0]), qcent=qcent)
                qmask_surv = lbs[:qg, :surv.size] <= thresh[:qg, None]
            d_surv, _ = solve_all(surv, qmask_surv, "survivor",
                                  warm=xprofs if self._warm() else None)
            d_cand = np.concatenate([d_seed, d_surv], axis=1)
        cand_ext = self._ext(cand)           # storage -> caller doc ids
        for g, qi in enumerate(live_q):
            order = np.argsort(d_cand[g], kind="stable")[:k]
            out_i[qi, :order.size] = cand_ext[order]
            out_d[qi, :order.size] = d_cand[g, order]
            solved[qi] = cand.size

def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _read(t: torch.Tensor) -> np.ndarray:
    """A device result read back to the host (a ``wmd.wait`` span)."""
    with trace.span("wmd.wait"):
        return t.cpu().numpy()


def _chunk_attrs(span, chunk: list, vr: list, width: int,
                 r: torch.Tensor) -> None:
    """A ``wmd.chunk`` span's attributes: its live queries, their words
    (from ``_plan``'s counts), the staged width and the padded count."""
    span.set(queries=len(chunk), query_words=sum(vr[qi] for qi in chunk),
             width=width, qp=int(r.shape[0]))
