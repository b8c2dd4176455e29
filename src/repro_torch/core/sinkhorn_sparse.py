"""Solve-stage numeric policy and the distance-line helpers (port of the
parts of ``repro.core.sinkhorn_sparse`` the kernel path uses; the
einsum solvers and the adaptive loops are not ported yet)."""
from __future__ import annotations

from typing import NamedTuple

import torch


class SolvePrecision(NamedTuple):
    """Which dtype the GEMMs run in and whether the kernel matrix is kept
    in the log domain.

    ``log_domain=True`` keeps ``log K = -lam*M`` unexponentiated through
    the gather and max-subtracts per gathered column inside the solve, so
    an all-zero K column — the :class:`~.sinkhorn.LamUnderflowError`
    failure mode — cannot occur at any ``lam``; the distance line picks up
    the exact correction ``-(1/lam) sum_l shift*val``
    (:func:`log_shift_correction`).

    Spellings accepted by :meth:`parse`: ``"fp32"``, ``"bf16"``,
    ``"log"``, ``"bf16+log"`` (order-insensitive). The port's engine runs
    only the fp32 GEMM policy so far.
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
    def name(self) -> str:
        return self.gemm + ("+log" if self.log_domain else "")


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
