"""Plain PyTorch versions of the port's kernels.

Each function computes, step by step in torch, the same function as its
Hopper kernel in ``csrc/``. The CPU path of :mod:`.ops` and the tests use
them; ``chip_smoke.py`` holds each kernel against its plain version on
the card. Nothing on the CUDA path of the engine calls them.
"""
from __future__ import annotations

import torch


def _safe_inv(x: torch.Tensor) -> torch.Tensor:
    pos = x > 0
    return torch.where(pos, 1.0 / torch.where(pos, x, torch.ones_like(x)),
                       torch.zeros_like(x))


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
