"""Sparse Sinkhorn-Knopp WMD — the paper's contribution (§4) — and the
solve-stage numeric policy (port of ``repro.core.sinkhorn_sparse``; the
adaptive loops, ``tol``/``check_every``, are not ported yet).

The dense hot line ``v = c.multiply(1 / (K.T @ u))`` computes a (V, N)
product and throws away all but nnz(c) of it. With
``G[k, n, l] = K[k, idx[n, l]]`` gathered once before the loop (K is
loop-invariant), each iteration is

    t[n, l] = sum_k G[k, n, l] * u[k, n]        # SDDMM
    w[n, l] = val[n, l] / t[n, l]               # sparse selection
    x[k, n] = sum_l G[k, n, l] / r[k] * w[n, l] # SpMM

which is 4*N*L*v_r flops per iteration against the dense 4*N*V*v_r.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .sinkhorn import LamUnderflowError, cdist, gemm_round, underflow_report


class SolvePrecision(NamedTuple):
    """Which dtype the GEMMs run in and whether the kernel matrix is kept
    in the log domain.

    ``gemm="bf16"`` rounds the cdist and SDDMM/SpMM operands to bf16 and
    keeps products, sums, ``x`` and the marginals in fp32.

    ``log_domain=True`` keeps ``log K = -lam*M`` unexponentiated through
    the gather and max-subtracts per gathered column inside the solve, so
    an all-zero K column — the :class:`~.sinkhorn.LamUnderflowError`
    failure mode — cannot occur at any ``lam``; the distance line picks up
    the exact correction ``-(1/lam) sum_l shift*val``
    (:func:`log_shift_correction`).

    Spellings accepted by :meth:`parse`: ``"fp32"``, ``"bf16"``,
    ``"log"``, ``"bf16+log"`` (order-insensitive).
    """

    gemm: str = "fp32"        # "fp32" | "bf16"
    log_domain: bool = False

    @classmethod
    def parse(cls, spec) -> "SolvePrecision":
        if isinstance(spec, cls):
            return spec
        if spec is None:
            return cls()
        parts = [p.strip() for p in str(spec).split("+") if p.strip()]
        gemm, log_domain = "fp32", False
        for p in parts:
            if p in ("fp32", "bf16"):
                gemm = p
            elif p == "log":
                log_domain = True
            else:
                raise ValueError(
                    f"unknown precision token {p!r} in {spec!r}; spell it "
                    f"from {{'fp32', 'bf16', 'log'}} joined by '+'")
        return cls(gemm=gemm, log_domain=log_domain)

    @property
    def gemm_dtype(self):
        return torch.bfloat16 if self.gemm == "bf16" else None

    @property
    def name(self) -> str:
        return self.gemm + ("+log" if self.log_domain else "")


class SparsePrecompute(NamedTuple):
    """Loop-invariant gathered tiles: everything the iteration touches.
    The (K*M) gather the distance line needs is rebuilt from G
    (:func:`reconstruct_gm`), so only two nnz-sized arrays exist."""

    G: torch.Tensor          # (v_r, N, L)  K columns at each doc's words
    G_over_r: torch.Tensor   # (v_r, N, L)  diag(1/r) G
    val: torch.Tensor        # (N, L)       normalized frequencies (0 = pad)


class SparsePrecomputeLog(NamedTuple):
    """Log-domain :class:`SparsePrecompute`: ``G`` holds
    ``exp(log K - shift)`` with ``shift[n, l] = max_k (-lam *
    M[k, idx[n, l]])``, so each gathered column's largest entry is exactly
    1. Only the distance line needs ``shift`` back."""

    G: torch.Tensor          # (v_r, N, L)  exp(-lam*M - shift), col-max == 1
    G_over_r: torch.Tensor   # (v_r, N, L)  diag(1/r) G
    val: torch.Tensor        # (N, L)       normalized frequencies (0 = pad)
    shift: torch.Tensor      # (N, L)       per-column max of -lam*M (<= 0)


def reconstruct_gm(g: torch.Tensor, lam) -> torch.Tensor:
    """(K*M) gathered == -G*log(G)/lam; G == 0 entries (padding or exp
    underflow) map to 0, matching the materialized gather."""
    pos = g > 0
    safe = torch.where(pos, g, torch.ones_like(g))
    return torch.where(pos, -g * torch.log(safe), torch.zeros_like(g)) / lam


def log_shift_correction(shift: torch.Tensor, val: torch.Tensor,
                         lam) -> torch.Tensor:
    """Exact distance-line correction for the log-domain rescale: with
    ``G' = G * exp(-shift)`` per column the selection satisfies
    ``t' * w' = val``, so the rescale contributes
    ``-(1/lam) sum_l shift[n, l] * val[n, l]`` — a per-doc constant."""
    return -(shift * val).sum(-1) / lam


def gather_columns(k: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(v_r, V) x (N, L) word ids -> (v_r, N, L) columns of ``k``: each
    doc's G tile, as every sparse solver and the kernel path read it."""
    n, length = idx.shape
    return k.index_select(1, idx.reshape(-1)).reshape(-1, n, length)


def precompute_sparse(r: torch.Tensor, vecs_sel: torch.Tensor,
                      vecs: torch.Tensor, docs, lam: float,
                      gemm_dtype=None) -> SparsePrecompute:
    """cdist -> K -> gather doc columns. One pass over (v_r, V), then
    O(nnz)."""
    k = torch.exp(-lam * cdist(vecs_sel, vecs, gemm_dtype))   # (v_r, V)
    g = gather_columns(k, docs.idx)
    return SparsePrecompute(G=g, G_over_r=g / r[:, None, None], val=docs.val)


def precompute_sparse_log(r: torch.Tensor, vecs_sel: torch.Tensor,
                          vecs: torch.Tensor, docs, lam: float,
                          gemm_dtype=None) -> SparsePrecomputeLog:
    """Log-domain precompute: ``log K = -lam*M`` is gathered
    unexponentiated and max-subtracted per column, so no column can
    underflow to all-zero at any ``lam``."""
    lg = gather_columns(-lam * cdist(vecs_sel, vecs, gemm_dtype), docs.idx)
    shift = lg.max(dim=0).values                              # (N, L), <= 0
    g = torch.exp(lg - shift[None])
    return SparsePrecomputeLog(G=g, G_over_r=g / r[:, None, None],
                               val=docs.val, shift=shift)


def _sddmm(g, u, gemm_dtype=None):
    """t[n, l] = sum_k G[k, n, l] u[k, n], fp32 products and sums."""
    return torch.einsum("knl,kn->nl", gemm_round(g, gemm_dtype),
                        gemm_round(u, gemm_dtype))


def _spmm(g_over_r, w, gemm_dtype=None):
    """x[k, n] = sum_l G_over_r[k, n, l] w[n, l], fp32 products and
    sums."""
    return torch.einsum("knl,nl->kn", gemm_round(g_over_r, gemm_dtype),
                        gemm_round(w, gemm_dtype))


def _inv(x, guarded: bool):
    """``1/x``; the guarded form maps non-positive entries to 0. The
    linear path keeps the raw division on purpose: an underflowed K
    column must surface as NaN so the :class:`LamUnderflowError` guard
    can trip. The log path guards, because a column cannot underflow there
    and a fully underflowed query-word row should drop out."""
    if not guarded:
        return 1.0 / x
    pos = x > 0
    return torch.where(pos, 1.0 / torch.where(pos, x, 1.0), 0.0)


def _select(live, val, t, guarded: bool):
    """Sparse selection ``w = val/t`` on live slots (0 elsewhere)."""
    if not guarded:
        return torch.where(live, val / t, 0.0)
    ok = live & (t > 0)
    return torch.where(ok, val / torch.where(ok, t, 1.0), 0.0)


def _iterate(pre, n_iter: int, gemm_dtype=None,
             guarded: bool = False) -> torch.Tensor:
    """The fixed ``n_iter`` fused SDDMM -> SpMM loop from x = 1/v_r."""
    v_r, n = pre.G.shape[:2]
    live = pre.val > 0
    x = torch.full((v_r, n), 1.0 / v_r, dtype=torch.float32,
                   device=pre.G.device)
    for _ in range(n_iter):
        w = _select(live, pre.val, _sddmm(pre.G, _inv(x, guarded),
                                          gemm_dtype), guarded)
        x = _spmm(pre.G_over_r, w, gemm_dtype)
    return x


def sinkhorn_wmd_sparse(r: torch.Tensor, vecs_sel: torch.Tensor,
                        vecs: torch.Tensor, docs, lam: float, n_iter: int,
                        check_underflow: bool = True, tol=None,
                        precision=None, return_iters: bool = False):
    """Sparse fused Sinkhorn WMD: the same distances as the dense Alg. 1.
    ``docs`` holds (N, L) ``idx``/``val`` tensors on ``vecs``' device; pad
    slots (val == 0) give w == 0 and contribute nothing.

    ``precision`` is a :class:`SolvePrecision` or its spelling. ``tol``
    (the convergence-adaptive loop) is not ported yet and raises
    ``NotImplementedError``; the loop runs ``n_iter`` iterations.
    ``return_iters=True`` also returns that count.

    A ``K = exp(-lam*M)`` underflow raises
    :class:`~.sinkhorn.LamUnderflowError` with a host-side diagnosis
    instead of returning NaN distances. The check syncs the (N,) result;
    ``check_underflow=False`` skips it (``one_to_many`` runs its own)."""
    if tol is not None:
        raise NotImplementedError(
            "tol (the adaptive solve) is not ported yet; the sparse solver "
            "runs a fixed n_iter (ROADMAP queue 1, item 5)")
    precision = SolvePrecision.parse(precision)
    gd = precision.gemm_dtype
    guarded = precision.log_domain
    if precision.log_domain:
        pre = precompute_sparse_log(r, vecs_sel, vecs, docs, lam, gd)
    else:
        pre = precompute_sparse(r, vecs_sel, vecs, docs, lam, gd)
    u = _inv(_iterate(pre, n_iter, gd, guarded), guarded)
    w = _select(pre.val > 0, pre.val, _sddmm(pre.G, u, gd), guarded)
    # wmd[n] = sum_k u[k,n] * sum_l GM[k,n,l] w[n,l]  (the paper's final
    # line); GM rebuilt from G, never stored
    wmd = torch.einsum("kn,knl,nl->n", u, reconstruct_gm(pre.G, lam), w)
    if precision.log_domain:
        wmd = wmd + log_shift_correction(pre.shift, pre.val, lam)
    if check_underflow and r.shape[0] > 0 and bool(torch.isnan(wmd).any()):
        raise LamUnderflowError(underflow_report(lam, vecs_sel, vecs, docs))
    return (wmd, n_iter) if return_iters else wmd


def sinkhorn_wmd_sparse_unfused(r: torch.Tensor, vecs_sel: torch.Tensor,
                                vecs: torch.Tensor, docs, lam: float,
                                n_iter: int) -> torch.Tensor:
    """Paper-faithful unfused sparse variant: separate SDDMM then SpMM,
    gathering K and K_over_r again every iteration (the paper's Fig. 3
    pair before the SDDMM_SpMM fusion); the fusion ablation's baseline."""
    m = cdist(vecs_sel, vecs)
    k = torch.exp(-lam * m)
    k_over_r = k / r[:, None]
    live = docs.val > 0
    x = torch.full((r.shape[0], docs.idx.shape[0]), 1.0 / r.shape[0],
                   dtype=k.dtype, device=k.device)
    idx = docs.idx
    for _ in range(n_iter):
        t = torch.einsum("knl,kn->nl", gather_columns(k, idx), 1.0 / x)
        w = torch.where(live, docs.val / t, 0.0)
        x = torch.einsum("knl,nl->kn", gather_columns(k_over_r, idx), w)
    u = 1.0 / x
    t = torch.einsum("knl,kn->nl", gather_columns(k, idx), u)
    w = torch.where(live, docs.val / t, 0.0)
    return torch.einsum("kn,knl,nl->n", u, gather_columns(k * m, idx), w)
