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


def _normal_inv(x: torch.Tensor) -> torch.Tensor:
    """K5's guarded inverse: 0 where ``x`` is below the smallest normal
    fp32 (subnormal, zero or negative), as the reference's fp32 gives it,
    whose subnormals flush to zero. ``_safe_inv`` of a subnormal overflows
    to inf, and a dead slot's ``0 * inf`` is NaN."""
    pos = x >= torch.finfo(torch.float32).tiny
    return torch.where(pos, 1.0 / torch.where(pos, x, torch.ones_like(x)),
                       torch.zeros_like(x))


def operand_dtype(gemm: str):
    """The operand dtype of a ``gemm`` policy: ``torch.bfloat16`` or None
    (fp32)."""
    if gemm not in ("fp32", "bf16"):
        raise ValueError(f"gemm must be 'fp32' or 'bf16', got {gemm!r}")
    return torch.bfloat16 if gemm == "bf16" else None


def cdist_exp_ref(a: torch.Tensor, b: torch.Tensor, r: torch.Tensor,
                  lam: float, k_only: bool = False, log_k: bool = False,
                  gemm: str = "fp32"):
    """Plain version of K3: a (v_r, w) query embeddings, b (V, w)
    vocabulary, r (v_r,) query weights -> (M, K, K/r), each (v_r, V), or K
    alone with ``k_only``. ``log_k`` makes K the unexponentiated
    ``-lam*M`` (the log-domain solve's input). ``gemm="bf16"`` rounds the
    operands of the a.b product to bf16; the norms and everything after
    stay fp32."""
    from repro_torch.core.sinkhorn import cdist
    m = cdist(a, b, operand_dtype(gemm))
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


def hold_cdist_exp(got, a, b, r, lam, k_only: bool, log_k: bool,
                   gemm: str = "fp32") -> dict:
    """K3's output ``got`` ((M, K, K/r), or K under ``k_only``) against
    :func:`cdist_exp_ref` on the same inputs, within K3's tolerance.
    Raises on a miss; returns the largest errors."""
    m_w, k_w, kr_w = cdist_exp_ref(a, b, r, lam, log_k=log_k, gemm=gemm)
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
                f"K3 {name} (k_only={k_only}, log_k={log_k}, gemm={gemm}): "
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
                                   block_n: int = 128, tol=None,
                                   check_every: int = 4, resmask=None,
                                   gemm: str = "fp32"):
    """Plain version of K1: the whole Sinkhorn solve and the distance line
    for every (query, doc) pair.

    g (Q, v_r, N, L): each query's gathered K (log K under
    ``log_domain``; pad query rows 0, or -inf under ``log_domain``);
    val (N, L) with 0 at pad slots; r (Q, v_r) with pad rows 1.
    Returns (wmd (Q, N), iters (Q, ceil(N / block_n))): the realized
    iteration count of each block of ``block_n`` docs, the largest of its
    docs' (``n_iter`` everywhere in fixed mode).

    Every doc is solved on its own: x starts at 1/(live rows of that doc)
    on its live rows. The reference kernel counts live rows per block of
    ``block_n`` docs; the two starts differ by a constant factor per doc,
    which scales x, u and w and cancels in the distance line and in the
    residual ratio.

    ``tol`` switches to the adaptive solve, with the exit PER DOC: after
    one seeded iteration and then every ``check_every`` iterations, a doc
    computes ``max_l |w - w_prev| / max(max_l |w|, 1e-30)`` over its
    slots in scope and stops once that ratio is not above ``tol`` (a NaN
    stops it too, as the reference's ``res > tol`` does) or once its count
    reaches ``n_iter``. The scope is the live slots (val > 0) of a doc
    whose ``resmask`` (Q, N) entry is > 0 (every doc without
    ``resmask``); an empty scope gives the ratio 0, so such a doc stops at
    the first check, after ``1 + check_every`` iterations. The reference
    exits per block of ``block_n`` docs instead, so a converged doc runs
    on there while its block mates converge (ROADMAP queue 3, P3).

    ``gemm="bf16"`` rounds the operands of both reductions to bf16 (G and
    G/r once, after the log-domain shift; u as the SDDMM operand, w as the
    SpMM operand); products and sums stay fp32, and the w of the residual
    and the u and w of the distance line are the unrounded ones.

    On live slots ``w = val * (1/t)`` without a guard in the linear
    domain: a K column that underflowed to all zero gives t == 0 and the
    doc's distance turns NaN, which the engine raises as
    :class:`~repro_torch.core.sinkhorn.LamUnderflowError`. Under
    ``log_domain`` no live column can be all zero; t == 0 (a fully
    underflowed query-word row) drops out instead.
    """
    wmd, counts, _ = solve_per_doc_ref(g, val, r, lam, n_iter, log_domain,
                                       tol, check_every, resmask, gemm)
    return wmd, block_iters(counts, block_n)


def inert_doc_iters(n_iter: int, tol=None, check_every: int = 4) -> int:
    """The realized count of an inert doc, one whose ``val`` row has no
    entry > 0, in :func:`sinkhorn_fused_all_batched_ref`: ``n_iter`` in
    fixed mode. In adaptive mode its scope is empty, so its ratio is 0 at
    every check: it stops at the first check after the seed, 1 +
    ``check_every`` (which may pass ``n_iter``), unless ``tol`` < 0 keeps
    it to the cap. Its distance is 0. K1's warp design skips the solve of
    a doc whose val row is all zero and writes these two values
    (``csrc/sinkhorn_fused.cu``)."""
    if tol is None:
        return n_iter
    count = 1
    while count < n_iter:
        count += check_every
        if not 0.0 > float(tol):
            break
    return count


def block_iters(counts: torch.Tensor, block_n: int) -> torch.Tensor:
    """(Q, N) per-doc realized counts -> (Q, ceil(N / block_n)), each
    block's largest."""
    q, n = counts.shape
    nb = -(-n // block_n)
    pad = torch.zeros((q, nb * block_n - n), dtype=counts.dtype,
                      device=counts.device)
    return torch.cat([counts, pad], dim=1).reshape(q, nb, block_n) \
        .max(dim=2).values


def solve_per_doc_ref(g, val, r, lam: float, n_iter: int,
                      log_domain: bool = False, tol=None,
                      check_every: int = 4, resmask=None,
                      gemm: str = "fp32"):
    """The arithmetic of :func:`sinkhorn_fused_all_batched_ref`, per doc:
    returns (wmd (Q, N), per-doc realized counts (Q, N) int32, margin
    (Q, N)). ``margin`` is the smallest ``|ratio - tol| / max(tol,
    1e-30)`` over the checks a doc made (+inf in fixed mode): where it is
    small, a kernel that sums in another order may take the other side of
    ``tol`` at that check (:func:`hold_solve`)."""
    from repro_torch.core.sinkhorn import gemm_round
    from repro_torch.core.sinkhorn_sparse import _doc_ratio
    rd = operand_dtype(gemm)
    q, v_r, n, length = g.shape
    shift = None
    if log_domain:
        shift = g.max(dim=1).values                            # (Q, N, L)
        shift = torch.where(torch.isfinite(shift), shift,
                            torch.zeros_like(shift))
        g = torch.where(torch.isfinite(g), torch.exp(g - shift[:, None]),
                        torch.zeros_like(g))
    gor = g * _safe_inv(r)[:, :, None, None]
    gb, gorb = gemm_round(g, rd), gemm_round(gor, rd)
    live = val > 0                                             # (N, L)
    rowlive = (g.abs().sum(dim=3) > 0).to(g.dtype)             # (Q, v_r, N)
    cnt = rowlive.sum(dim=1, keepdim=True)
    x = torch.where(rowlive > 0, 1.0 / torch.clamp(cnt, min=1.0),
                    torch.zeros_like(rowlive))

    def select(t):
        inv = 1.0 / t if not log_domain else _safe_inv(t)
        return torch.where(live[None], val[None] * inv, torch.zeros_like(t))

    def step(x):
        u = gemm_round(_safe_inv(x), rd)
        w = select((gb * u[..., None]).sum(dim=1))             # SDDMM (Q,N,L)
        return (gorb * gemm_round(w, rd)[:, None]).sum(dim=3), w   # SpMM

    margin = torch.full((q, n), float("inf"), device=g.device)
    if tol is None:
        for _ in range(n_iter):
            x, _ = step(x)
        counts = torch.full((q, n), n_iter, dtype=torch.int32,
                            device=g.device)
    else:
        tol = float(tol)
        scope = live[None].expand(q, n, length)
        if resmask is not None:
            scope = scope & (resmask > 0)[..., None]
        x, w_prev = step(x)
        counts = torch.ones((q, n), dtype=torch.int32, device=g.device)
        active = torch.ones((q, n), dtype=torch.bool, device=g.device)
        i = 1
        while i < n_iter and bool(active.any()):
            w = w_prev
            for _ in range(check_every):
                x_new, w_new = step(x)
                x = torch.where(active[:, None], x_new, x)
                w = torch.where(active[..., None], w_new, w)
            i += check_every
            counts = torch.where(active, i, counts)
            ratio = _doc_ratio(w, w_prev, scope)               # (Q, N)
            margin = torch.where(
                active, torch.minimum(margin, (ratio - tol).abs()
                                      / max(tol, 1e-30)), margin)
            active = active & (ratio > tol)
            w_prev = w
    u = _safe_inv(x)
    w = select((gb * gemm_round(u, rd)[..., None]).sum(dim=1))
    gm = reconstruct_gm_ref(g, lam)
    wmd = (u * (gm * w[:, None]).sum(dim=3)).sum(dim=1)        # (Q, N)
    if log_domain:
        wmd = wmd - (shift * val[None]).sum(dim=2) / lam
    return wmd, counts, margin


# hold_solve: a doc whose residual ratio came within this fraction of tol
# at one of its checks may stop one window earlier or later in a kernel
# that sums in another order (its w differs from the plain version's by a
# few ulps, and |w - w_prev| by that over the ratio); such docs are
# counted, and left out of the distance comparison
NEAR_TIE = 1e-2


def hold_solve(got_wmd, got_iters, g, val, r, lam, n_iter, rtol, atol,
               block_n: int = 128, **options) -> dict:
    """K1's (or, with a (v_r, N, L) ``g``, K4's) output against
    :func:`solve_per_doc_ref` on the same inputs. In fixed mode every
    distance is held at (rtol, atol) and every block count must equal
    ``n_iter``. In adaptive mode (``options`` has ``tol``) the same holds
    for every doc whose ratio never came within ``NEAR_TIE`` of ``tol``;
    a block whose count differs from the plain version's must hold such a
    near-tie doc. Raises on a miss; returns the errors and counts."""
    one = g.ndim == 3
    if one:
        g, r = g[None], r[None]
        got_wmd, got_iters = got_wmd[None], got_iters[None]
        if options.get("resmask") is not None:
            options["resmask"] = options["resmask"][None]
    want, counts, margin = solve_per_doc_ref(g, val, r, lam, n_iter,
                                             **options)
    want_iters = block_iters(counts, block_n)
    near = margin <= NEAR_TIE
    held = ~near
    fin = torch.isfinite(want)
    if not torch.equal(torch.isfinite(got_wmd)[held], fin[held]):
        raise AssertionError("solve: inf/NaN pattern differs from the "
                             "plain version")
    err = (got_wmd - want).abs()
    ok = err <= atol + rtol * want.abs()
    bad = held & fin & ~ok
    if bad.any():
        raise AssertionError(
            f"solve {options}: {int(bad.sum())} docs outside rtol={rtol} "
            f"atol={atol}; max abs err {float(err[bad].max())}")
    differs = got_iters != want_iters
    near_blocks = block_iters(near.to(torch.int32), block_n) > 0
    if (differs & ~near_blocks).any():
        raise AssertionError(
            f"solve {options}: {int((differs & ~near_blocks).sum())} block "
            "counts differ from the plain version without a near-tie doc")
    held_fin = held & fin
    return {"max_abs_err": float(err[held_fin].max()) if held_fin.any()
            else 0.0,
            "max_rel_err": float((err[held_fin] / want[held_fin].abs()
                                  .clamp(min=1e-30)).max())
            if held_fin.any() else 0.0,
            "near_tie_docs": int(near.sum()),
            "blocks_count_differs": int(differs.sum()),
            "blocks": int(differs.numel()),
            "mean_doc_iters": float(counts.float().mean()),
            "mean_block_iters": float(want_iters.float().mean())}


def sinkhorn_fused_all_ref(g: torch.Tensor, val: torch.Tensor,
                           r: torch.Tensor, lam: float, n_iter: int,
                           log_domain: bool = False, block_n: int = 128,
                           tol=None, check_every: int = 4, resmask=None,
                           gemm: str = "fp32"):
    """Plain version of K4, K1 for one query: g (v_r, N, L), val (N, L),
    r (v_r,), resmask (N,) -> (wmd (N,), iters (ceil(N / block_n),))."""
    wmd, iters = sinkhorn_fused_all_batched_ref(
        g[None], val, r[None], lam, n_iter, log_domain=log_domain,
        block_n=block_n, tol=tol, check_every=check_every,
        resmask=None if resmask is None else resmask[None], gemm=gemm)
    return wmd[0], iters[0]


def sddmm_spmm_step_ref(g: torch.Tensor, g_over_r: torch.Tensor,
                        val: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain version of K5, one fused SDDMM_SpMM iteration: g and g_over_r
    (v_r, N, L), val (N, L), x (v_r, N) -> x' (v_r, N) with
    u = 1/x, t = sum_k G u, w = val * (1/t), x' = sum_l (G/r) w, both
    inverses guarded (0 where the argument is below the smallest normal
    fp32: :func:`_normal_inv`)."""
    u = _normal_inv(x)
    t = (g * u[:, :, None]).sum(dim=0)                         # (N, L)
    w = val * _normal_inv(t)
    return (g_over_r * w[None]).sum(dim=2)                     # (v_r, N)


def bsr_panels(kt: torch.Tensor, u: torch.Tensor, brow: torch.Tensor,
               bcol: torch.Tensor, bv: int, bn: int):
    """The per-block operands of the block-sparse SDDMM, gathered by tile
    coordinate: kt (V, v_r) and u (v_r, N) -> ktb (nb, bv, v_r) row panels
    and ub (nb, v_r, bn) column panels. kt's rows and u's columns are
    zero-padded up to whole tiles first."""
    v_r = kt.shape[1]
    kt = torch.nn.functional.pad(kt, (0, 0, 0, -kt.shape[0] % bv))
    u = torch.nn.functional.pad(u, (0, -u.shape[1] % bn))
    ktb = kt.reshape(-1, bv, v_r).index_select(0, brow.long())
    ub = u.reshape(v_r, -1, bn).transpose(0, 1).index_select(0, bcol.long())
    return ktb, ub


def bsr_sddmm_blocks_ref(ktb: torch.Tensor, ub: torch.Tensor,
                         cblk: torch.Tensor) -> torch.Tensor:
    """Plain version of K6: for each retained block b,
    w[b] = cblk[b] * (ktb[b] @ ub[b]); ktb (nb, bv, v_r), ub (nb, v_r, bn),
    cblk (nb, bv, bn) -> (nb, bv, bn). The product is fp32 (no TF32 on the
    card: the port relies on ``allow_tf32`` being False)."""
    return cblk * torch.bmm(ktb, ub)


def bsr_sddmm_ref(kt: torch.Tensor, u: torch.Tensor, c_bsr) -> torch.Tensor:
    """The reference's oracle for the BSR SDDMM: the dense product
    kt (V, v_r) @ u (v_r, N), masked by the stored tiles and re-blocked
    -> (nb, bv, bn) aligned with ``c_bsr``."""
    bv, bn = c_bsr.block_shape
    vp, np_ = c_bsr.shape
    full = torch.nn.functional.pad(kt @ u, (0, np_ - u.shape[1],
                                           0, vp - kt.shape[0]))
    tiles = full.reshape(vp // bv, bv, np_ // bn, bn).permute(0, 2, 1, 3)
    return c_bsr.blocks * tiles[c_bsr.brow.long(), c_bsr.bcol.long()]


# K6's tolerance: the reference's (tests/test_kernels.py::test_bsr_sddmm),
# relative to the sum of the absolute products, |c| * (|kt| @ |u|): the
# kernel and the plain version's GEMM sum the v_r-long product in other
# orders, which moves each element by a few ulps of that sum
K6_RTOL = 1e-5


def hold_bsr_sddmm(got, ktb, ub, cblk, rtol: float = K6_RTOL) -> dict:
    """K6's output ``got`` against :func:`bsr_sddmm_blocks_ref` on the same
    panels: the same NaN/inf pattern, and every finite entry within
    ``rtol`` of |c| * (|kt| @ |u|). Raises on a miss; returns the largest
    errors."""
    want = bsr_sddmm_blocks_ref(ktb, ub, cblk)
    fin_g, fin_w = torch.isfinite(got), torch.isfinite(want)
    if not torch.equal(fin_g, fin_w):
        raise AssertionError("bsr_sddmm: inf/NaN pattern differs from the "
                             "plain version")
    scale = cblk.abs() * torch.bmm(ktb.abs(), ub.abs())
    err = torch.where(fin_w, (got - want).abs(), torch.zeros_like(want))
    bad = err > rtol * scale
    if bool(bad.any()):
        raise AssertionError(f"bsr_sddmm: {int(bad.sum())} entries outside "
                             f"rtol={rtol} of |c|(|kt||u|); max abs err "
                             f"{float(err.max())}")
    return {"max_abs_err": float(err.max()),
            "max_err_over_scale": float((err / scale.clamp(min=1e-30))
                                        .max())}
