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

``MaxPruner`` takes the elementwise max of several admissible bounds.
The IVF cascade is not ported yet.
"""
from __future__ import annotations

import functools
from typing import Protocol, Sequence, runtime_checkable

import torch

from repro_torch.kernels import ops


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
        minm = torch.where(torch.isfinite(minm), minm,
                           torch.zeros_like(minm))
        return _rwmd_gather(minm, index.docs.idx, index.docs.val)


class MaxPruner:
    """Elementwise max of several admissible bounds (still admissible)."""

    def __init__(self, pruners: Sequence[Pruner]):
        self.pruners = tuple(pruners)
        self.name = "+".join(p.name for p in self.pruners)

    def lower_bounds(self, index, sup, r, mask):
        bounds = [p.lower_bounds(index, sup, r, mask) for p in self.pruners]
        return functools.reduce(torch.maximum, bounds)


def _keep_any(lbm: torch.Tensor, thresh: torch.Tensor) -> torch.Tensor:
    """Columns any live query still needs: lbm (Qp, S), thresh (qc,)
    margined thresholds -> (S,) bool."""
    return (lbm[:thresh.shape[0]] <= thresh[:, None]).any(dim=0)


PRUNERS = ("wcd", "rwmd", "wcd+rwmd")


def resolve_pruner(spec, nprobe: int | None = None):
    """Turn a spec (``"wcd"``, ``"rwmd"``, ``"wcd+rwmd"``) or a
    :class:`Pruner` instance into a pruner. The IVF cascades
    (``"ivf..."``) are not ported yet and raise ``NotImplementedError``."""
    if isinstance(spec, str):
        parts = [p.strip() for p in spec.replace(",", "+").split("+") if p]
        if parts and parts[0] == "ivf":
            raise NotImplementedError(
                f"prune={spec!r}: the IVF cascade is not ported yet "
                "(ROADMAP queue 1, item 5)")
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
            else:
                raise ValueError(
                    f"unknown pruner {p!r}; pick from {PRUNERS} or pass a "
                    f"Pruner instance")
        if not made:
            raise ValueError(f"empty pruner spec {spec!r}")
        return made[0] if len(made) == 1 else MaxPruner(made)
    if isinstance(spec, Pruner):
        if nprobe is not None:
            raise ValueError(
                f"nprobe={nprobe} only applies to ivf cascades; "
                f"{type(spec).__name__} sweeps every document")
        return spec
    raise TypeError(f"prune must be a str, None, or Pruner, got {spec!r}")
