"""Sinkhorn-Knopp balanced MoE router: the paper's solver inside the LM
stack (port of ``repro.core.router``).

Token->expert assignment with load balance is a small optimal-transport
problem: row marginal = one unit of routing mass per token, column
marginal = equal capacity per expert. The same matrix-scaling iteration the
WMD solver runs (log domain) gives a balanced soft assignment, and the MoE
layer takes its top k. The iteration count is small (~4-8): the problem is
tiny and well conditioned.
"""
from __future__ import annotations

import math

import torch


def sinkhorn_route(logits: torch.Tensor, n_iter: int = 6,
                   n_real: int | None = None) -> torch.Tensor:
    """Balanced assignment probabilities from router logits.

    ``logits`` (..., T, E) -> plan (..., T, E) whose rows sum to 1 and
    whose columns sum to T/n_real at the fixed point. Log-domain
    Sinkhorn-Knopp with K = exp(logits) (cost -logits, lam = 1), f and g
    started at zero.

    ``n_real``: when experts are TP-padded (E > the true expert count),
    the padded columns get column marginal -inf (zero mass), as the WMD
    solver treats empty ``c`` columns, so no mass is forced onto dead
    experts. ``torch.logsumexp`` returns -inf (not NaN) on an all -inf
    slice, so those columns stay -inf through the iteration.
    """
    t, e = logits.shape[-2], logits.shape[-1]
    n_real = e if n_real is None else n_real
    log_r = -math.log(t)                                 # each token: 1/T
    col = torch.full((e,), -math.log(n_real), dtype=logits.dtype,
                     device=logits.device)
    col[n_real:] = -math.inf
    f = logits.new_zeros(logits.shape[:-1])              # (..., T)
    g = logits.new_zeros(logits.shape[:-2] + (e,))       # (..., E)
    dead = torch.isneginf(col)
    for _ in range(n_iter):
        f = log_r - torch.logsumexp(logits + g[..., None, :], dim=-1)
        g = col - torch.logsumexp(logits + f[..., :, None], dim=-2)
        g = g.masked_fill(dead, -math.inf)
    plan = torch.exp(f[..., :, None] + logits + g[..., None, :])
    # renormalize rows to probabilities (T * plan rows sum ~= 1 already)
    return plan / plan.sum(-1, keepdim=True).clamp(min=1e-9)


def topk_route(logits: torch.Tensor) -> torch.Tensor:
    """Standard softmax router (the baseline the Sinkhorn router is
    compared against)."""
    return torch.softmax(logits, dim=-1)


def route(logits: torch.Tensor, kind: str, n_iter: int = 6,
          n_real: int | None = None) -> torch.Tensor:
    if n_real is not None and n_real < logits.shape[-1]:
        # mask padded experts so top-k never selects them
        logits = logits.clone()
        logits[..., n_real:] = -1e30
    if kind == "sinkhorn":
        return sinkhorn_route(logits, n_iter=n_iter, n_real=n_real)
    if kind == "topk":
        return topk_route(logits)
    raise ValueError(f"unknown router kind: {kind!r}")
