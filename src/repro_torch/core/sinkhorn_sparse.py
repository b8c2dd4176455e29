"""Sparse Sinkhorn-Knopp WMD — the paper's contribution (§4) — the
solve-stage numeric policy and the convergence-adaptive loops (port of
``repro.core.sinkhorn_sparse``).

The dense hot line ``v = c.multiply(1 / (K.T @ u))`` computes a (V, N)
product and throws away all but nnz(c) of it. With
``G[k, n, l] = K[k, idx[n, l]]`` gathered once before the loop (K is
loop-invariant), each iteration is

    t[n, l] = sum_k G[k, n, l] * u[k, n]        # SDDMM
    w[n, l] = val[n, l] / t[n, l]               # sparse selection
    x[k, n] = sum_l G[k, n, l] / r[k] * w[n, l] # SpMM

which is 4*N*L*v_r flops per iteration against the dense 4*N*V*v_r.

The adaptive loops (:func:`adaptive_loop`, :func:`adaptive_loop_scoped`)
replace the reference's ``lax.while_loop``, which has no eager
counterpart, with a Python loop that syncs to the host once per check
(``bool(res > tol)``), i.e. once every ``check_every`` iterations. The
window is seeded with one iteration, so realized counts land on
``1 + k*check_every`` and overshoot the ``n_iter`` cap by at most
``check_every - 1``, as in the reference.
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


def marginal_residual(w, w_prev, mask) -> torch.Tensor:
    """Relative doc-marginal residual, the adaptive loops' exit
    statistic: ``max_doc max_slot |w - w_prev| / max_slot |w|`` over the
    ``mask``-live slots (the last axis is the slot axis). Masked slots add
    0 to both the diff and the scale, so pad docs and queries can neither
    stall the loop nor release it early; an all-masked doc's 0/1e-30 is
    exactly 0. A NaN propagates (and then ends the loop, as in the
    reference, whose ``res > tol`` is false for NaN)."""
    return _doc_ratio(w, w_prev, mask).max()


def marginal_residual_per_query(w, w_prev, mask) -> torch.Tensor:
    """The :func:`marginal_residual` statistic reduced per QUERY: ``w`` is
    (Q, ..., L) with a leading query axis; each doc's diff is normalized
    by that doc's own scale before the max over the query's docs. Returns
    (Q,). ``mask`` is each query's residual scope: a query whose scope is
    empty reduces to exactly 0 and converges at the first check."""
    ratio = _doc_ratio(w, w_prev, mask)
    return ratio.reshape(ratio.shape[0], -1).max(dim=1).values


def _doc_ratio(w, w_prev, mask) -> torch.Tensor:
    zero = torch.zeros((), dtype=w.dtype, device=w.device)
    diff = torch.where(mask, (w - w_prev).abs(), zero).max(dim=-1).values
    scale = torch.where(mask, w.abs(), zero).max(dim=-1).values
    return diff / torch.clamp(scale, min=1e-30)


def adaptive_loop(step, residual, x0, n_iter: int, tol: float,
                  check_every: int):
    """Convergence-adaptive driver shared by the sparse solvers:
    ``step(x) -> (x, w)`` runs one iteration and ``residual(w, w_prev)``
    reduces to the scalar exit statistic (:func:`marginal_residual` with
    the caller's mask). One seeded iteration, then windows of
    ``check_every`` iterations until the residual is no longer above
    ``tol`` or the count reaches ``n_iter``. Returns (x, realized count),
    the count on ``1 + k*check_every``. One host sync per check."""
    x, w_prev = step(x0)
    i = 1
    while i < n_iter:
        for _ in range(check_every):
            x, w = step(x)
        i += check_every
        if not bool(residual(w, w_prev) > tol):
            break
        w_prev = w
    return x, i


def adaptive_loop_scoped(step, residual, x0, n_iter: int, tol: float,
                         check_every: int, live_q, all_reduce=None):
    """Per-query convergence-adaptive driver: a (Q,) residual vector and
    a per-query convergence state. ``step(x, active) -> (x, w)`` runs one
    iteration with the (Q,) bool ``active`` mask; ``residual(w, w_prev)``
    returns (Q,) (:func:`marginal_residual_per_query`). A query freezes
    its x (axis 0 is the query axis) once converged, for good; the loop
    ends when every ``live_q`` query has converged or the count reaches
    ``n_iter``. Returns ``(x, iters_q)``, iters_q (Q,) int32: the
    iterations each query's x absorbed (fillers stay at the seed's 1).
    One host sync per check.

    ``all_reduce`` (optional) agrees on the residual across shards, as
    the reference's ``lax.pmax``: ``x`` and ``w`` may then be lists of
    per-position tensors (the distributed solver's), ``residual`` returns
    their per-position vectors and ``all_reduce`` the one (Q,) vector on
    ``live_q``'s device. Without it nothing changes for a tensor ``x``."""
    x, w_prev = step(x0, live_q)
    conv = torch.zeros_like(live_q)
    iters_q = torch.ones(live_q.shape, dtype=torch.int32,
                         device=live_q.device)
    i = 1
    while i < n_iter and bool((live_q & ~conv).any()):
        active = live_q & ~conv
        for _ in range(check_every):
            x_new, w = step(x, active)
            x = _freeze(active, x_new, x)
        i += check_every
        res = residual(w, w_prev)
        if all_reduce is not None:
            res = all_reduce(res)
        iters_q = torch.where(active, i, iters_q)
        conv = conv | (active & (res <= tol))
        w_prev = w
    return x, iters_q


def _freeze(active, x_new, x):
    """``x_new`` for the ``active`` queries (axis 0), ``x`` for the
    others; a list of per-position tensors maps position by position."""
    if isinstance(x_new, torch.Tensor):
        act_b = active.reshape((-1,) + (1,) * (x_new.ndim - 1))
        return torch.where(act_b, x_new, x)
    return [_freeze(active.to(n.device), n, o) for n, o in zip(x_new, x)]


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


def _step(pre, x, gemm_dtype, guarded: bool):
    """One fused SDDMM -> SpMM iteration: (x', w)."""
    w = _select(pre.val > 0, pre.val,
                _sddmm(pre.G, _inv(x, guarded), gemm_dtype), guarded)
    return _spmm(pre.G_over_r, w, gemm_dtype), w


def _x0(pre) -> torch.Tensor:
    v_r, n = pre.G.shape[:2]
    return torch.full((v_r, n), 1.0 / v_r, dtype=torch.float32,
                      device=pre.G.device)


def _iterate(pre, n_iter: int, gemm_dtype=None,
             guarded: bool = False) -> torch.Tensor:
    """The fixed ``n_iter`` fused SDDMM -> SpMM loop from x = 1/v_r."""
    x = _x0(pre)
    for _ in range(n_iter):
        x, _ = _step(pre, x, gemm_dtype, guarded)
    return x


def _iterate_adaptive(pre, n_iter: int, tol: float, check_every: int,
                      gemm_dtype=None, guarded: bool = False,
                      doc_mask=None):
    """Convergence-adaptive loop (:func:`adaptive_loop`): ``n_iter`` is a
    cap and the exit statistic is the doc-marginal residual over live
    slots, narrowed by ``doc_mask`` (N,) to the docs the caller needs
    (the others keep iterating but cannot hold the loop open). Returns
    (x, realized count)."""
    mask = pre.val > 0
    if doc_mask is not None:
        mask = mask & doc_mask[:, None]
    return adaptive_loop(
        lambda x: _step(pre, x, gemm_dtype, guarded),
        lambda w, wp: marginal_residual(w, wp, mask),
        _x0(pre), n_iter, tol, check_every)


def sinkhorn_wmd_sparse(r: torch.Tensor, vecs_sel: torch.Tensor,
                        vecs: torch.Tensor, docs, lam: float, n_iter: int,
                        check_underflow: bool = True, tol=None,
                        check_every: int = 4, precision=None,
                        return_iters: bool = False, doc_mask=None):
    """Sparse fused Sinkhorn WMD: the same distances as the dense Alg. 1.
    ``docs`` holds (N, L) ``idx``/``val`` tensors on ``vecs``' device; pad
    slots (val == 0) give w == 0 and contribute nothing.

    ``precision`` is a :class:`SolvePrecision` or its spelling. ``tol``
    switches to the convergence-adaptive loop (:func:`adaptive_loop`):
    ``n_iter`` becomes a cap, the residual is checked every
    ``check_every`` iterations, and realized counts land on
    ``1 + k*check_every``. ``doc_mask`` (N,) bool narrows the exit test
    to the docs the caller will read; the distances of the others are
    still returned, they just cannot delay the exit.
    ``return_iters=True`` also returns the realized count.

    A ``K = exp(-lam*M)`` underflow raises
    :class:`~.sinkhorn.LamUnderflowError` with a host-side diagnosis
    instead of returning NaN distances. The check syncs the (N,) result;
    ``check_underflow=False`` skips it (``one_to_many`` runs its own)."""
    precision = SolvePrecision.parse(precision)
    gd = precision.gemm_dtype
    guarded = precision.log_domain
    if tol is not None and int(check_every) < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    if precision.log_domain:
        pre = precompute_sparse_log(r, vecs_sel, vecs, docs, lam, gd)
    else:
        pre = precompute_sparse(r, vecs_sel, vecs, docs, lam, gd)
    if tol is None:
        x, iters = _iterate(pre, n_iter, gd, guarded), n_iter
    else:
        if doc_mask is not None:
            doc_mask = torch.as_tensor(doc_mask, dtype=torch.bool,
                                       device=pre.val.device)
        x, iters = _iterate_adaptive(pre, n_iter, float(tol),
                                     int(check_every), gd, guarded, doc_mask)
    u = _inv(x, guarded)
    w = _select(pre.val > 0, pre.val, _sddmm(pre.G, u, gd), guarded)
    # wmd[n] = sum_k u[k,n] * sum_l GM[k,n,l] w[n,l]  (the paper's final
    # line); GM rebuilt from G, never stored
    wmd = torch.einsum("kn,knl,nl->n", u, reconstruct_gm(pre.G, lam), w)
    if precision.log_domain:
        wmd = wmd + log_shift_correction(pre.shift, pre.val, lam)
    if check_underflow and r.shape[0] > 0 and bool(torch.isnan(wmd).any()):
        raise LamUnderflowError(underflow_report(lam, vecs_sel, vecs, docs))
    return (wmd, iters) if return_iters else wmd


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
