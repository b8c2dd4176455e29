"""Admissible lower bounds for the staged retrieval pipeline (port of the
full-sweep pruners of ``repro.core.prune``).

``WmdEngine.search`` runs prune -> solve -> rank: a cheap lower bound on
every (query, doc) pair first, the Sinkhorn solve only on the candidates
the bound cannot exclude.

``RwmdPruner`` (doc-side relaxed WMD)
    ``lb[q, n] = sum_l val[n, l] * min_k M[k, idx[n, l]]``. The engine's
    plan moves exactly ``val[n, l]`` out of each doc word, so the bound is
    below the computed truncated-Sinkhorn score (up to fp rounding, which
    the engine's ``prune_slack`` covers). The exact-top-k guarantee rests
    on it. The masked min-cdist runs in the Hopper kernel K2
    (:func:`repro_torch.kernels.ops.rwmd_min_cdist`).

``WcdPruner`` (word-centroid distance)
    ``lb[q, n] = ||sum_k r_k vec_k - centroid_n||``: admissible for exact
    EMD, near-exact for the truncated score (see the reference's notes).
    The truncated solve moves the document's mass exactly but not the
    query's, so the WCD of the query's own weights can pass its score by
    ~20% on near-duplicates (w = 300, lam = 10, 15 iterations). The
    cascade therefore ranks by WCD and prunes by :func:`_wcd_admissible`.

``MaxPruner`` takes the elementwise max of several admissible bounds.

``CascadePruner`` runs the stages cheapest-first over a shrinking
candidate set instead: IVF cluster probe and cluster-radius filter, pivot
triangle bounds, WCD on the shortlist, and RWMD only on the WCD survivors
and only over the vocabulary those survivors use, through the Hopper
kernel K2s (:func:`repro_torch.kernels.ops.rwmd_min_cdist_subset`). See
its docstring for the exactness-vs-``nprobe`` contract.

Host and device: the stage functions below are plain torch on the
index's device. What the reference reads back with ``np.asarray`` the
port reads back with ``.cpu()``, which syncs; the drivers keep those
reads to compact id arrays and bool masks, and thresholds stay on the
device.

Tracing (``repro_torch.trace``): the cascade's stages record the spans
``wmd.cascade.probe``, ``wmd.cascade.seed``, ``wmd.cascade.first`` (the
gathered first stage here; the engine opens it around the seed pick),
``wmd.cascade.vocab`` (``_rwmd_vocab`` and ``_upload_prep``) and
``wmd.cascade.rwmd`` (K2s), each with the documents in and out where it
prunes; every device-to-host read is a ``wmd.wait`` span and every host
array uploaded counts into ``h2d_pageable_bytes``.
"""
from __future__ import annotations

import functools
from typing import Protocol, Sequence, runtime_checkable

import numpy as np
import torch

from repro_torch.kernels import ops

from .. import trace
from .index import _read


@runtime_checkable
class Pruner(Protocol):
    """One prune stage: admissible lower bounds for a prepared query chunk.

    ``sup``/``r``/``mask`` are the engine's bucketed chunk layout ((Qp, B)
    support word ids, frequencies with pad rows == 1, live-row mask).
    Returns (Qp, N) bounds in storage doc order; rows past the live
    queries are don't-care."""

    name: str

    def lower_bounds(self, index, sup: torch.Tensor, r: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor: ...


def _wcd_bounds(qcent: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    a2 = (qcent * qcent).sum(1)[:, None]
    b2 = (centroids * centroids).sum(1)[None, :]
    d2 = a2 + b2 - 2.0 * (qcent @ centroids.T)
    return torch.sqrt(torch.clamp(d2, min=0.0))


def _query_centroids(sup, r, mask, vecs):
    return torch.einsum("qb,qbw->qw", r * mask, vecs[sup])  # pad rows masked


class WcdPruner:
    """Word-centroid distance: one (Qp, w) x (w, N) GEMM per chunk."""

    name = "wcd"

    def lower_bounds(self, index, sup, r, mask):
        return _wcd_bounds(_query_centroids(sup, r, mask, index.vecs),
                           index.centroids)


def _finite(minm: torch.Tensor) -> torch.Tensor:
    """+inf (all-pad filler rows) -> 0: those rows carry no live mass."""
    return torch.where(torch.isfinite(minm), minm, torch.zeros_like(minm))


def _rwmd_gather(minm: torch.Tensor, idx: torch.Tensor,
                 val: torch.Tensor) -> torch.Tensor:
    """(Qp, V) min distances -> (Qp, N) bounds: gather at each doc's words,
    weight by the doc's mass."""
    return torch.einsum("qnl,nl->qn", minm[:, idx], val)


class RwmdPruner:
    """Doc-side relaxed WMD — tight, provably <= the engine's score."""

    name = "rwmd"

    def lower_bounds(self, index, sup, r, mask):
        a = index.vecs[sup]                          # (Qp, B, w)
        minm = ops.rwmd_min_cdist(a, mask, index.vecs)
        # all-pad filler rows have minm == +inf; they are sliced off later
        return _rwmd_gather(_finite(minm), index.docs.idx, index.docs.val)


class MaxPruner:
    """Elementwise max of several admissible bounds (still admissible)."""

    def __init__(self, pruners: Sequence[Pruner]):
        self.pruners = tuple(pruners)
        self.name = "+".join(p.name for p in self.pruners)

    def lower_bounds(self, index, sup, r, mask):
        bounds = [p.lower_bounds(index, sup, r, mask) for p in self.pruners]
        return functools.reduce(torch.maximum, bounds)


def _keep_any(lbm: torch.Tensor, thresh: torch.Tensor) -> torch.Tensor:
    """Columns any live query still needs: lbm (Qp, S) with +inf at
    non-candidates, thresh (qc,) margined thresholds -> (S,) bool."""
    return (lbm[:thresh.shape[0]] <= thresh[:, None]).any(dim=0)


# ---------------------------------------------------------------- cascade
# survivors(): when the cluster filter keeps at least this share of the
# corpus, the speculative dense first-stage pass replaces the gathered one
DENSE_CUTOFF = 0.25


def _pad_pow2_ids(ids: np.ndarray, min_size: int = 8) -> np.ndarray:
    """Pow2-pad a host id array (pad slots get id 0, a valid row whose
    bounds the candidacy masks exclude), as the reference does to bound
    its compiled shapes; kept so both packages stage the same arrays."""
    n_pad = min_size
    while n_pad < ids.size:
        n_pad *= 2
    out = np.zeros(n_pad, np.int32)
    out[:ids.size] = ids
    return out


def _smallest(x: torch.Tensor, k: int):
    """(values, indices) of the k smallest entries of each row, ties to
    the lower index: the order ``jax.lax.top_k(-x, k)`` gives (a plain
    ``torch.topk`` leaves the tie order open)."""
    vals, idx = torch.sort(x, dim=1, stable=True)
    return vals[:, :k], idx[:, :k]


def _live_slots(n: int, n_real: int, device) -> torch.Tensor:
    return torch.arange(n, device=device) < n_real


def _wcd_stage(qcent, centroids, ids_pad, qmask):
    """Centroid bounds for a candidate id array (device), +inf where
    ``qmask`` is False."""
    lb = _wcd_bounds(qcent, centroids[ids_pad])
    return torch.where(qmask, lb, torch.full_like(lb, float("inf")))


def _wcd_admissible(qcent, a, mask, points) -> torch.Tensor:
    """A lower bound on the engine's truncated score from centroids:
    (Qp, w) query centroids, (Qp, B, w) query word vectors with their
    (Qp, B) live mask, (S, w) points (document centroids or cluster
    centers) -> (Qp, S).

    The solve's plan P moves each document word's mass exactly, and the
    query's only approximately: its row sums r' are some distribution over
    the query's words. With u the unit vector from the point c towards the
    query centroid q, the score is sum P_kl |v_k - v_l| >= |sum_k r'_k v_k
    - c| >= <sum_k r'_k v_k - c, u> >= min_k <v_k - c, u> = |q - c| -
    max_k <q - v_k, u>, whatever r' is: the WCD less the query's spread
    towards the point (WCD assumes r' = r). A point within radius rho of
    every document of a cluster bounds them all by the same less rho."""
    wcd = _wcd_bounds(qcent, points)
    qa = qcent[:, None, :] - a                           # (Qp, B, w)
    proj = (qa * qcent[:, None, :]).sum(-1)[:, :, None] - qa @ points.T
    proj = torch.where(mask[:, :, None] > 0, proj,
                       torch.full_like(proj, -float("inf")))
    spread = torch.clamp(proj.amax(dim=1), min=0.0)      # (Qp, S)
    return torch.where(wcd > 0, wcd - spread / torch.clamp(wcd, min=1e-30),
                       torch.zeros_like(wcd))


def _prune_bound(admissible: bool):
    """The centroid bound the cascade's prune tests take, with
    :func:`_wcd_admissible`'s signature: that bound, or the plain WCD
    (tighter, but the truncated score can undercut it)."""
    if admissible:
        return _wcd_admissible
    return lambda qcent, a, mask, points: _wcd_bounds(qcent, points)


def _dense_keep(lb, pm, assign, thresh):
    """Dense threshold pass over every doc: (Qp, N) bounds -> (N,) bool of
    docs some live query still needs; with candidacy through the doc ->
    probed-cluster lookup where ``pm`` is given (``assign`` the device
    mirror)."""
    qc = thresh.shape[0]
    keep = lb[:qc] <= thresh[:, None]
    if pm is not None:
        keep = keep & pm[:qc][:, assign]
    return keep.any(dim=0)


def _pivot_lb(qd, dd) -> torch.Tensor:
    """max_p |d(q, p) - d(n, p)|: (Qp, P) x (S, P) -> (Qp, S)."""
    return (qd[:, None, :] - dd[None, :, :]).abs().amax(dim=-1)


def _pivot_stage(qd, dd, ids_pad, qmask):
    """Pivot triangle bounds for a candidate id array, +inf where
    ``qmask`` is False."""
    lb = _pivot_lb(qd, dd[ids_pad])
    return torch.where(qmask, lb, torch.full_like(lb, float("inf")))


def _pivot_dense_keep(qd, dd, pm, assign, thresh):
    """Dense pivot threshold pass over every doc, with candidacy."""
    qc = thresh.shape[0]
    lb = _pivot_lb(qd[:qc], dd)
    return (pm[:qc][:, assign] & (lb <= thresh[:, None])).any(dim=0)


def _pivot_dense_keep_all(qd, dd, thresh):
    """Exhaustive-probe variant of :func:`_pivot_dense_keep`."""
    lb = _pivot_lb(qd[:thresh.shape[0]], dd)
    return (lb <= thresh[:, None]).any(dim=0)


def _rwmd_epilogue(minm, rel, val, qmask):
    """RWMD gather + doc-mass contraction + candidacy fold: (Qp, Vc)
    subset min distances, rel/val (Sp, L) -> (Qp, Sp), +inf where
    ``qmask`` is False."""
    lb = _rwmd_gather(_finite(minm), rel, val)
    return torch.where(qmask, lb, torch.full_like(lb, float("inf")))


def _rwmd_keep(minm, rel, val, pm, assign_ids, n_real, thresh):
    """:func:`_rwmd_epilogue` fused with the candidacy lookup and the
    threshold test -> (Sp,) bool."""
    qc = thresh.shape[0]
    lb = _rwmd_gather(_finite(minm[:qc]), rel, val)
    cand = (pm[:qc][:, assign_ids]
            & _live_slots(assign_ids.shape[0], n_real, lb.device)[None, :])
    return (cand & (lb <= thresh[:, None])).any(dim=0)


def _rwmd_keep_all(minm, rel, val, n_real, thresh):
    """Exhaustive-probe variant of :func:`_rwmd_keep` (only the pad tail
    is masked)."""
    qc = thresh.shape[0]
    lb = _rwmd_gather(_finite(minm[:qc]), rel, val)
    keep = (lb <= thresh[:, None]).any(dim=0)
    return keep & _live_slots(rel.shape[0], n_real, lb.device)


def _cluster_keep(lbc, radii, pm, thresh):
    """Cluster-radius filter: a center's bound (:func:`_wcd_admissible`)
    less the radius, + candidacy where ``pm`` is given + threshold test ->
    (C,) bool of clusters some live query still needs."""
    lbm = lbc - radii[None, :]
    if pm is not None:
        lbm = torch.where(pm, lbm, torch.full_like(lbm, float("inf")))
    return _keep_any(lbm, thresh)


def _probe_dists(sup, r, mask, vecs, centers):
    """Query centroids and cluster-center distances: (cdists (Qp, C),
    qcent (Qp, w), reused by the WCD and pivot stages)."""
    qcent = _query_centroids(sup, r, mask, vecs)
    return _wcd_bounds(qcent, centers), qcent


def _probe_mask(cdists, nprobe: int) -> torch.Tensor:
    """(Qp, C) bool: True at each query's ``nprobe`` nearest clusters
    (ties to the lower cluster id, as the reference's ``top_k``)."""
    _, idx = _smallest(cdists, nprobe)
    pm = torch.zeros(cdists.shape, dtype=torch.bool, device=cdists.device)
    return pm.scatter_(1, idx, True)


def _ids_qmask(pm, assign_ids, n_real):
    """Per-query candidacy for a padded doc-id array: the doc's cluster
    must be probed by the query, and the slot must be real."""
    return (pm[:, assign_ids]
            & _live_slots(assign_ids.shape[0], n_real, pm.device)[None, :])


class CascadePruner:
    """Cheapest-first cascade over a shrinking candidate set: IVF cluster
    probe + cluster-radius filter -> pivot triangle bounds -> per-doc WCD
    -> RWMD min-cdist (the reference's ``CascadePruner``).

    1. *ivf probe*: one (Q, n_clusters) distance block against the frozen
       k-means centers. ``nprobe`` nearest clusters per query define the
       candidate universe (all clusters when ``nprobe=None``, the exact
       mode). Seed docs come from each query's nearest probed clusters,
       just enough to cover k members.
    2. *ivf radius filter*: after the seed solve fixes the threshold t_q,
       the centroid bound of the cluster's center less its radius
       (:func:`_wcd_admissible`) drops whole clusters.
    3. *pivot* (optional): ``max_p |d(q, p) - d(n, p)|`` over the index's
       pivot words, a lower bound on WCD at O(P) per pair.
    4. *wcd*: the centroid bound on the surviving clusters' members. WCD
       ranks the seed candidates; the prune tests use
       :func:`_wcd_admissible` (:meth:`prune_bounds`), which the truncated
       score cannot undercut.
    5. *rwmd*: the tight bound, on the WCD survivors only, over the
       vocabulary those survivors use (Hopper kernel K2s).

    At ``nprobe = n_clusters`` the result is the exhaustive top-k (every
    prune test an admissible bound, up to ``prune_slack``), except through
    the pivot stage, which bounds WCD and stays near-exact. At smaller
    ``nprobe`` un-probed clusters
    are never scored: approximate retrieval whose recall is monotone in
    ``nprobe`` for a fixed query batch. The driver is
    :meth:`repro_torch.core.index.WmdEngine.search`; this class owns the
    stage computations.
    """

    def __init__(self, stages: Sequence[str] = ("wcd", "rwmd"),
                 nprobe: int | None = None):
        stages = tuple(stages)
        if not stages or any(s not in ("pivot", "wcd", "rwmd")
                             for s in stages):
            raise ValueError(f"cascade stages must be drawn from "
                             f"('pivot', 'wcd', 'rwmd'), got {stages!r}")
        self.stages = stages
        self.nprobe = nprobe
        self.name = "+".join(("ivf",) + stages)

    # -------------------------------------------------------- stage 0: ivf
    def probe(self, index, sup, r, mask, nprobe: int | None = None):
        """Cluster probe for one query staging: (cdists (Qp, C), pm (Qp,
        C) bool or ``None`` for the exhaustive probe, qcent (Qp, w)), all
        on the device. ``nprobe=None`` uses the pruner's own, which itself
        defaults to all clusters."""
        cl = index.clusters
        if cl is None:
            raise ValueError(
                "CorpusIndex has no IVF clusters — rebuild with "
                "build_index() (clusters are built by default)")
        if nprobe is None:
            nprobe = self.nprobe
        c = cl.n_clusters
        np_eff = c if nprobe is None else max(1, min(int(nprobe), c))
        with trace.span("wmd.cascade.probe") as s:
            if s:
                s.set(docs_in=index.n_docs, clusters=c, nprobe=np_eff)
            cdists, qcent = _probe_dists(sup, r, mask, index.vecs,
                                         cl.centers)
            # pm None == exhaustive probe: the stages skip the candidacy
            # lookups
            pm = None if np_eff == c else _probe_mask(cdists, np_eff)
            return cdists, pm, qcent

    def seed_candidates(self, index, cdists, mask, k: int,
                        pm) -> np.ndarray:
        """Seed-candidate doc ids: per live query, walk probed clusters
        nearest-first until they cover k members; the union across the
        staging, cluster-sorted (host, O(Q * C))."""
        cl = index.clusters
        sizes = cl.sizes
        c = cl.n_clusters
        with trace.span("wmd.cascade.seed") as s:
            # one device -> host copy for cdists, the live rows and pm
            parts = [cdists, mask.sum(dim=1, keepdim=True).to(cdists.dtype)]
            if pm is not None:
                parts.append(pm.to(cdists.dtype))
            host = _read(torch.cat(parts, dim=1))
            cd, live = host[:, :c], host[:, c] > 0
            pm_np = None if pm is None else host[:, c + 1:] > 0
            chosen = np.zeros(c, bool)
            for q in np.nonzero(live)[0]:
                covered = 0
                for ci in np.argsort(cd[q], kind="stable"):
                    if ((pm_np is not None and not pm_np[q, ci])
                            or sizes[ci] == 0):
                        continue
                    chosen[ci] = True
                    covered += sizes[ci]
                    if covered >= k:
                        break
            out = self.cluster_members(index, chosen)
            if s:
                probed = (index.n_docs if pm_np is None
                          else int(sizes[pm_np[live].any(axis=0)].sum()))
                s.set(docs_in=probed, docs_out=int(out.size))
            return out

    def id_qmask(self, index, pm, ids_pad: np.ndarray, n_real: int,
                 qp: int | None = None) -> torch.Tensor:
        """(Qp, Sp) candidacy for a padded id array (see _ids_qmask).
        ``pm=None`` (exhaustive probe) needs ``qp`` to shape the mask."""
        dev = index.device
        if pm is None:
            valid = _live_slots(ids_pad.size, n_real, dev)
            return valid[None, :].expand(qp, ids_pad.size)
        assign = index.clusters.assign[ids_pad].astype(np.int64)
        trace.add("h2d_pageable_bytes", assign.nbytes)
        return _ids_qmask(pm, torch.as_tensor(assign, device=dev), n_real)

    def cluster_members(self, index, keep_c: np.ndarray) -> np.ndarray:
        """Cluster-sorted doc ids of the kept clusters (host slice concat,
        a near-contiguous storage run under the cluster-major layout)."""
        cl = index.clusters
        kept = np.nonzero(keep_c[:cl.n_clusters])[0]
        if kept.size == 0:
            return np.zeros(0, np.int32)
        return np.concatenate(
            [cl.order[cl.starts[c]:cl.starts[c + 1]] for c in kept])

    @staticmethod
    def _radii(index) -> torch.Tensor:
        radii = index.clusters.radii.astype(np.float32)
        trace.add("h2d_pageable_bytes", radii.nbytes)
        return torch.as_tensor(radii, device=index.device)

    # --------------------------------------- post-threshold survivor pass
    def survivors(self, index, sup, r, mask, pm, qcent, thresh,
                  exclude: np.ndarray | None = None,
                  live_rows: np.ndarray | None = None,
                  admissible: bool = True) -> np.ndarray:
        """The post-threshold prune pass, cheapest-first: cluster-radius
        filter, then the per-doc stages on what remains. Returns surviving
        doc ids (``exclude``, typically the solved seeds, removed).

        The cluster filter and a speculative dense first-stage pass over
        every doc are issued together and read back in one copy: when the
        cluster filter keeps at least ``DENSE_CUTOFF`` of the corpus the
        dense result replaces the gathered first stage (both tests are
        admissible, so the dense one alone is), else it is discarded.
        ``live_rows`` (each staged
        query's live rows, known while tracing) fills the
        ``wmd.cascade.rwmd`` span's ``rows`` and ``queries``;
        ``admissible=False`` prunes by the plain WCD (:func:`_prune_bound`)."""
        cl = index.clusters
        bound = _prune_bound(admissible)
        radii = self._radii(index)
        stages = self.stages
        a = index.vecs[sup]
        c = cl.centers.shape[0]
        keep_d_dev = None
        if stages[0] == "wcd":
            # the centers' and every document's bounds in one pass
            lb = bound(qcent, a, mask,
                       torch.cat([cl.centers, index.centroids]))
            keep_d_dev = _dense_keep(lb[:, c:], pm, cl.assign_dev, thresh)
        else:
            lb = bound(qcent, a, mask, cl.centers)
        keep_c_dev = _cluster_keep(lb[:, :c], radii, pm, thresh)
        if stages[0] == "pivot":
            qd = _query_pivot_dists(index, qcent)
            if pm is None:
                keep_d_dev = _pivot_dense_keep_all(qd, index.doc_pivot_d,
                                                   thresh)
            else:
                keep_d_dev = _pivot_dense_keep(qd, index.doc_pivot_d, pm,
                                               cl.assign_dev, thresh)
        both = _read(keep_c_dev if keep_d_dev is None
                     else torch.cat([keep_c_dev, keep_d_dev]))
        keep_c = both[:c]
        kept_docs = int(cl.sizes[keep_c[:cl.n_clusters]].sum())
        if (keep_d_dev is not None
                and kept_docs >= DENSE_CUTOFF * index.n_docs):
            surv = np.nonzero(both[c:])[0].astype(np.int32)
            stages = stages[1:]
        else:
            surv = self.cluster_members(index, keep_c)
        if exclude is not None and exclude.size and surv.size:
            surv = surv[~np.isin(surv, exclude)]
        for stage in stages:
            if surv.size == 0:
                break
            sp = _pad_pow2_ids(surv)
            if stage == "rwmd":
                with trace.span("wmd.cascade.rwmd") as s:
                    prep = self._rwmd_prep(index, sup, mask, sp, surv.size)
                    if prep is None:
                        break
                    minm, rel, val = _upload_prep(prep, index.device)
                    if pm is None:
                        keep = _rwmd_keep_all(minm, rel, val, surv.size,
                                              thresh)
                    else:
                        assign = cl.assign[sp].astype(np.int64)
                        trace.add("h2d_pageable_bytes", assign.nbytes)
                        keep = _rwmd_keep(
                            minm, rel, val, pm,
                            torch.as_tensor(assign, device=index.device),
                            surv.size, thresh)
                    out = surv[_read(keep)[:surv.size]]
                    if s:
                        _rwmd_attrs(s, live_rows, minm.shape[1], surv.size)
                        s.set(docs_out=int(out.size))
            else:
                with trace.span("wmd.cascade.first") as s:
                    lbm = self.prune_bounds(
                        stage, index, sup, r, mask, sp, surv.size,
                        self.id_qmask(index, pm, sp, surv.size,
                                      qp=sup.shape[0]), qcent=qcent,
                        admissible=admissible)
                    out = surv[_read(_keep_any(lbm, thresh))[:surv.size]]
                    if s:
                        s.set(docs_in=int(surv.size), docs_out=int(out.size))
            surv = out
        return surv

    # ----------------------------------------------------- bounded stages
    def prune_bounds(self, stage: str, index, sup, r, mask,
                     ids_pad: np.ndarray, n_real: int, qmask: torch.Tensor,
                     qcent: torch.Tensor | None = None,
                     live_rows: np.ndarray | None = None,
                     admissible: bool = True) -> torch.Tensor:
        """:meth:`stage_bounds` as the prune tests take them: the ``"wcd"``
        stage by :func:`_wcd_admissible`, which the truncated score cannot
        undercut, in WCD's place (which ranks); by WCD itself where
        ``admissible`` is False."""
        if stage != "wcd" or not admissible:
            return self.stage_bounds(stage, index, sup, r, mask, ids_pad,
                                     n_real, qmask, qcent, live_rows)
        if qcent is None:
            qcent = _query_centroids(sup, r, mask, index.vecs)
        ids_np = ids_pad.astype(np.int64)
        trace.add("h2d_pageable_bytes", ids_np.nbytes)
        ids = torch.as_tensor(ids_np, device=index.device)
        lb = _wcd_admissible(qcent, index.vecs[sup], mask,
                             index.centroids[ids])
        return torch.where(qmask, lb, torch.full_like(lb, float("inf")))

    def stage_bounds(self, stage: str, index, sup, r, mask,
                     ids_pad: np.ndarray, n_real: int, qmask: torch.Tensor,
                     qcent: torch.Tensor | None = None,
                     live_rows: np.ndarray | None = None) -> torch.Tensor:
        """Masked lower bounds for one cascade stage on a candidate id
        array: (Qp, Sp) on the device, +inf wherever ``qmask`` is False
        (pad slots and per-query non-candidates). Pass the ``qcent`` the
        probe computed to skip recomputing the query centroids;
        ``live_rows`` as :meth:`survivors`."""
        if stage in ("wcd", "pivot"):
            if qcent is None:
                qcent = _query_centroids(sup, r, mask, index.vecs)
            ids_np = ids_pad.astype(np.int64)
            trace.add("h2d_pageable_bytes", ids_np.nbytes)
            ids = torch.as_tensor(ids_np, device=index.device)
            if stage == "pivot":
                return _pivot_stage(_query_pivot_dists(index, qcent),
                                    index.doc_pivot_d, ids, qmask)
            return _wcd_stage(qcent, index.centroids, ids, qmask)
        return self._rwmd_subset(index, sup, mask, ids_pad, n_real, qmask,
                                 live_rows)

    @staticmethod
    def _rwmd_vocab(index, ids_pad, n_real):
        """Host staging of the RWMD subset, numpy as in the reference:
        gather the candidate rows of the host mirror and map their word ids
        into the compact candidate vocabulary. Returns (vids (Vc,) int64,
        the distinct live words in increasing order, rel (Sp, L), val (Sp,
        L)) or None when the subset has no live word. The reference pads
        the candidate vocabulary to a power of two (>= 128) repeating
        vids[0]; those columns are computed and never gathered, so K2s here
        gets Vc unpadded: the bounds are the same, with up to half the
        columns fewer. The distinct words are marked in a (V,) table and
        each live slot's rank read from its running count: what np.unique
        and np.searchsorted give, without sorting the thousands of
        candidates an exact cascade can pass here."""
        idx = index.docs_host.idx[ids_pad]
        val = index.docs_host.val[ids_pad].copy()
        val[n_real:] = 0.0                    # pad rows out of the vocab
        nnz = (val > 0).sum(axis=1)
        lg = max(1, int(nnz.max(initial=0)))
        lg = min(-(-lg // 8) * 8, idx.shape[1])
        idx, val = idx[:, :lg], val[:, :lg]
        live = val > 0
        words = idx[live]
        if words.size == 0:
            return None
        if words.min() < 0 or words.max() >= index.vocab_size:
            # K2s on the card does not check its ids: do it here, on the host
            raise ValueError(f"candidate word ids outside the vocabulary "
                             f"[0, {index.vocab_size})")
        mark = np.zeros(index.vocab_size, bool)
        mark[words] = True
        rel = np.zeros(idx.shape, np.int32)
        rel[live] = (np.cumsum(mark, dtype=np.int32) - 1)[words]
        return np.flatnonzero(mark).astype(np.int64), rel, val

    def _rwmd_prep(self, index, sup, mask, ids_pad, n_real):
        """The RWMD subset stage's producer: :meth:`_rwmd_vocab`, then K2s
        on the candidate vocabulary's embedding rows only, so the (Q*B, V)
        block shrinks to (Q*B, Vc), Vc the distinct live words. Returns
        (minm device (Qp, Vc), rel np, val np) or None when the subset has
        no live word."""
        with trace.span("wmd.cascade.vocab") as s:
            staged = self._rwmd_vocab(index, ids_pad, n_real)
            if s:
                s.set(docs=int(n_real),
                      vc=0 if staged is None else int(staged[0].size))
        if staged is None:
            return None
        vids, rel, val = staged
        trace.add("h2d_pageable_bytes", vids.nbytes)
        minm = ops.rwmd_min_cdist(
            index.vecs[sup], mask, index.vecs,
            vocab_ids=torch.as_tensor(vids, device=index.device))
        return minm, rel, val

    def _rwmd_subset(self, index, sup, mask, ids_pad, n_real, qmask,
                     live_rows=None):
        """Masked RWMD bounds on a candidate subset (see _rwmd_prep)."""
        with trace.span("wmd.cascade.rwmd") as s:
            prep = self._rwmd_prep(index, sup, mask, ids_pad, n_real)
            if prep is None:
                return torch.where(qmask, 0.0, float("inf"))
            minm, rel, val = _upload_prep(prep, index.device)
            if s:
                _rwmd_attrs(s, live_rows, minm.shape[1], n_real)
            return _rwmd_epilogue(minm, rel, val, qmask)


def _query_pivot_dists(index, qcent) -> torch.Tensor:
    """(Qp, P) query-centroid distances to the index's pivot words."""
    if index.pivots is None:
        raise ValueError("cascade has a 'pivot' stage but the index has no "
                         "pivot words — rebuild with build_index("
                         "n_pivots > 0)")
    from .index import _pivot_dists
    return _pivot_dists(qcent, index.pivots)


def _upload_prep(prep, device):
    """K2s's (Qp, Vc) output with the candidates' ``rel`` (as int64) and
    ``val`` uploaded, in a ``wmd.cascade.vocab`` span."""
    minm, rel, val = prep
    with trace.span("wmd.cascade.vocab"):
        rel = rel.astype(np.int64)
        trace.add("h2d_pageable_bytes", rel.nbytes + val.nbytes)
        return (minm, torch.as_tensor(rel, device=device),
                torch.as_tensor(val, device=device))


def _rwmd_attrs(span, live_rows, vc: int, docs_in: int) -> None:
    """A ``wmd.cascade.rwmd`` span's attributes: the staged queries' live
    rows and their count (where known), the candidate vocabulary's size
    and the documents bounded."""
    if live_rows is not None:
        span.set(rows=int(live_rows.sum()),
                 queries=int(np.count_nonzero(live_rows)))
    span.set(vc=int(vc), docs_in=int(docs_in))


PRUNERS = ("wcd", "rwmd", "wcd+rwmd", "ivf", "ivf+wcd", "ivf+rwmd",
           "ivf+wcd+rwmd", "ivf+pivot+wcd+rwmd", "ivf+pivot+rwmd")


def resolve_pruner(spec, nprobe: int | None = None):
    """Turn a spec (``"wcd"``, ``"rwmd"``, ``"wcd+rwmd"``, a cascaded
    ``"ivf[+pivot][+wcd][+rwmd]"``, or a :class:`Pruner` /
    :class:`CascadePruner` instance) into a pruner. ``nprobe`` applies to
    cascades only (``None`` probes every cluster, the exact mode)."""
    if isinstance(spec, str):
        parts = [p.strip() for p in spec.replace(",", "+").split("+") if p]
        if parts and parts[0] == "ivf":
            stages = tuple(parts[1:]) or ("wcd", "rwmd")
            return CascadePruner(stages=stages, nprobe=nprobe)
        if nprobe is not None:
            raise ValueError(
                f"nprobe={nprobe} only applies to ivf cascades; "
                f"{spec!r} sweeps every document")
        made = []
        for p in parts:
            if p == "wcd":
                made.append(WcdPruner())
            elif p == "rwmd":
                made.append(RwmdPruner())
            elif p == "pivot":
                raise ValueError(
                    "the pivot prestage reads the index's precomputed "
                    "doc_pivot_d table and runs inside the ivf cascade — "
                    "spell it 'ivf+pivot+...'")
            else:
                raise ValueError(
                    f"unknown pruner {p!r}; pick from {PRUNERS} or pass a "
                    f"Pruner instance")
        if not made:
            raise ValueError(f"empty pruner spec {spec!r}")
        return made[0] if len(made) == 1 else MaxPruner(made)
    if isinstance(spec, CascadePruner):
        if nprobe is not None and spec.nprobe != nprobe:
            raise ValueError(
                f"nprobe={nprobe} conflicts with the CascadePruner's own "
                f"nprobe={spec.nprobe}; set it on the pruner")
        return spec
    if isinstance(spec, Pruner):
        if nprobe is not None:
            raise ValueError(
                f"nprobe={nprobe} only applies to ivf cascades; "
                f"{type(spec).__name__} sweeps every document")
        return spec
    raise TypeError(f"prune must be a str, None, or Pruner, got {spec!r}")
