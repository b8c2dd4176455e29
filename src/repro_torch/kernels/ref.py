"""Plain PyTorch versions of the port's kernels.

Each function computes, step by step in torch, the same function as its
Hopper kernel in ``csrc/``. The CPU path of :mod:`.ops` and the tests use
them; ``chip_smoke.py`` holds each kernel against its plain version on
the card (K3 through :func:`hold_cdist_exp`, which the GPU tests share).
Nothing on the CUDA path of the engine calls them.
"""
from __future__ import annotations

import torch


def _safe_inv(x: torch.Tensor) -> torch.Tensor:
    pos = x > 0
    return torch.where(pos, 1.0 / torch.where(pos, x, torch.ones_like(x)),
                       torch.zeros_like(x))


def cdist_exp_ref(a: torch.Tensor, b: torch.Tensor, r: torch.Tensor,
                  lam: float, k_only: bool = False, log_k: bool = False):
    """Plain version of K3: a (v_r, w) query embeddings, b (V, w)
    vocabulary, r (v_r,) query weights -> (M, K, K/r), each (v_r, V), or K
    alone with ``k_only``. ``log_k`` makes K the unexponentiated
    ``-lam*M`` (the log-domain solve's input)."""
    from repro_torch.core.sinkhorn import cdist
    m = cdist(a, b)
    k = -lam * m if log_k else torch.exp(-lam * m)
    if k_only:
        return k
    return m, k, k / r[:, None]


# K3's tolerance. The kernel sums a.b in another order than the plain
# version's GEMM, which moves the squared distance |a|^2+|b|^2-2a.b by a few
# ulps of |a|^2+|b|^2 (at exact word matches, d ~ 0, the sqrt turns that
# into ~2e-2 of M). So M is held in squared distance, per entry:
# |got^2 - want^2| <= K3_SQ_RTOL * (|a_k|^2 + |b_v|^2). That bounds
# |dM| <= min(sqrt(tol), tol / M); K is held within what dM allows,
# K * (exp(lam*dM) - 1) (lam*dM under log_k), K/r within K's tolerance
# over r, each plus K3_ULP for the exp and the division.
K3_SQ_RTOL = 1e-5
K3_ULP = 1e-6


def hold_cdist_exp(got, a, b, r, lam, k_only: bool, log_k: bool) -> dict:
    """K3's output ``got`` ((M, K, K/r), or K under ``k_only``) against
    :func:`cdist_exp_ref` on the same inputs, within K3's tolerance.
    Raises on a miss; returns the largest errors."""
    m_w, k_w, kr_w = cdist_exp_ref(a, b, r, lam, log_k=log_k)
    m_g, k_g, kr_g = (None, got, None) if k_only else got
    tol_sq = K3_SQ_RTOL * ((a * a).sum(-1)[:, None]
                           + (b * b).sum(-1)[None, :])
    dm = torch.minimum(tol_sq.sqrt(), tol_sq / m_w.clamp(min=1e-30))
    if log_k:
        k_tol = lam * dm + K3_ULP * k_w.abs()
    else:
        k_tol = k_w * torch.expm1(lam * dm) + K3_ULP * k_w
    out = {"max_abs_err": float((k_g - k_w).abs().max())}
    checks = [("K", k_g, k_w, k_tol)]
    if not k_only:
        out["m_max_sq_err_over_scale"] = float(
            ((m_g * m_g - m_w * m_w).abs() / tol_sq * K3_SQ_RTOL).max())
        out["m_max_abs_err"] = float((m_g - m_w).abs().max())
        out["kr_max_abs_err"] = float((kr_g - kr_w).abs().max())
        checks += [("M^2", m_g * m_g, m_w * m_w, tol_sq),
                   ("K/r", kr_g, kr_w,
                    k_tol / r[:, None] + K3_ULP * kr_w.abs())]
    for name, g, w, tol in checks:
        if not torch.isfinite(g).all():
            raise AssertionError(f"K3 {name}: non-finite output")
        bad = (g - w).abs() > tol
        if bad.any():
            raise AssertionError(
                f"K3 {name} (k_only={k_only}, log_k={log_k}): "
                f"{int(bad.sum())} entries outside tolerance; max err/tol "
                f"{float(((g - w).abs() / tol).max())}")
    return out


def rwmd_min_cdist_ref(a: torch.Tensor, mask: torch.Tensor,
                       b: torch.Tensor) -> torch.Tensor:
    """Masked min-over-support distances (plain version of K2).

    a (Q, B, w) support embeddings, mask (Q, B) with 0 at padded support
    rows, b (V, w) vocabulary -> minM (Q, V); rows whose mask is all zero
    come out +inf."""
    a2 = (a * a).sum(-1)[:, :, None]
    b2 = (b * b).sum(-1)[None, None, :]
    ab = torch.matmul(a, b.T)                              # (Q, B, V)
    d = torch.sqrt(torch.clamp(a2 + b2 - 2.0 * ab, min=0.0))
    d = torch.where(mask[:, :, None] > 0, d,
                    torch.full_like(d, float("inf")))
    return d.min(dim=1).values


def rwmd_min_cdist_subset_ref(a: torch.Tensor, mask: torch.Tensor,
                              b: torch.Tensor,
                              vocab_ids: torch.Tensor) -> torch.Tensor:
    """Plain version of K2s: K2 over the vocabulary rows ``b[vocab_ids]``
    -> (Q, Vc) in ``vocab_ids`` order."""
    return rwmd_min_cdist_ref(a, mask, b[vocab_ids])


def reconstruct_gm_ref(g: torch.Tensor, lam: float) -> torch.Tensor:
    """GM = -G*log(G)/lam with G == 0 entries mapped to 0."""
    pos = g > 0
    safe = torch.where(pos, g, torch.ones_like(g))
    return torch.where(pos, -g * torch.log(safe) / lam, torch.zeros_like(g))


def sinkhorn_fused_all_batched_ref(g: torch.Tensor, val: torch.Tensor,
                                   r: torch.Tensor, lam: float, n_iter: int,
                                   log_domain: bool = False,
                                   block_n: int = 128):
    """Plain version of K1: the whole fixed-``n_iter`` Sinkhorn solve and
    the distance line for every (query, doc) pair.

    g (Q, v_r, N, L): each query's gathered K (log K under
    ``log_domain``; pad query rows 0, or -inf under ``log_domain``);
    val (N, L) with 0 at pad slots; r (Q, v_r) with pad rows 1.
    Returns (wmd (Q, N), iters (Q, ceil(N / block_n)) filled with
    ``n_iter``).

    Every doc is solved on its own: x starts at 1/(live rows of that doc)
    on its live rows. The reference kernel counts live rows per block of
    ``block_n`` docs; the two starts differ by a constant factor per doc,
    which scales x, u and w and cancels in the distance line.

    On live slots ``w = val * (1/t)`` without a guard in the linear
    domain: a K column that underflowed to all zero gives t == 0 and the
    doc's distance turns NaN, which the engine raises as
    :class:`~repro_torch.core.sinkhorn.LamUnderflowError`. Under
    ``log_domain`` no live column can be all zero; t == 0 (a fully
    underflowed query-word row) drops out instead.
    """
    q, v_r, n, length = g.shape
    shift = None
    if log_domain:
        shift = g.max(dim=1).values                            # (Q, N, L)
        shift = torch.where(torch.isfinite(shift), shift,
                            torch.zeros_like(shift))
        g = torch.where(torch.isfinite(g), torch.exp(g - shift[:, None]),
                        torch.zeros_like(g))
    gor = g * _safe_inv(r)[:, :, None, None]
    live = val > 0                                             # (N, L)
    rowlive = (g.abs().sum(dim=3) > 0).to(g.dtype)             # (Q, v_r, N)
    cnt = rowlive.sum(dim=1, keepdim=True)
    x = torch.where(rowlive > 0, 1.0 / torch.clamp(cnt, min=1.0),
                    torch.zeros_like(rowlive))

    def select(t):
        inv = 1.0 / t if not log_domain else _safe_inv(t)
        return torch.where(live[None], val[None] * inv, torch.zeros_like(t))

    for _ in range(n_iter):
        u = _safe_inv(x)
        t = (g * u[..., None]).sum(dim=1)                      # SDDMM (Q,N,L)
        w = select(t)
        x = (gor * w[:, None]).sum(dim=3)                      # SpMM (Q,v_r,N)
    u = _safe_inv(x)
    t = (g * u[..., None]).sum(dim=1)
    w = select(t)
    gm = reconstruct_gm_ref(g, lam)
    wmd = (u * (gm * w[:, None]).sum(dim=3)).sum(dim=1)        # (Q, N)
    if log_domain:
        wmd = wmd - (shift * val[None]).sum(dim=2) / lam
    n_blocks = -(-n // block_n)
    iters = torch.full((q, n_blocks), n_iter, dtype=torch.int32,
                       device=g.device)
    return wmd, iters


def sinkhorn_fused_all_ref(g: torch.Tensor, val: torch.Tensor,
                           r: torch.Tensor, lam: float, n_iter: int,
                           log_domain: bool = False, block_n: int = 128):
    """Plain version of K4, K1 for one query: g (v_r, N, L), val (N, L),
    r (v_r,) -> (wmd (N,), iters (ceil(N / block_n),))."""
    wmd, iters = sinkhorn_fused_all_batched_ref(
        g[None], val, r[None], lam, n_iter, log_domain=log_domain,
        block_n=block_n)
    return wmd[0], iters[0]


def sddmm_spmm_step_ref(g: torch.Tensor, g_over_r: torch.Tensor,
                        val: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain version of K5, one fused SDDMM_SpMM iteration: g and g_over_r
    (v_r, N, L), val (N, L), x (v_r, N) -> x' (v_r, N) with
    u = 1/x, t = sum_k G u, w = val * (1/t), x' = sum_l (G/r) w, both
    inverses guarded (0 where the argument is not positive)."""
    u = _safe_inv(x)
    t = (g * u[:, :, None]).sum(dim=0)                         # (N, L)
    w = val * _safe_inv(t)
    return (g_over_r * w[None]).sum(dim=2)                     # (v_r, N)
