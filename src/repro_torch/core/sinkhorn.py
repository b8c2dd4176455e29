"""Shared pieces of the Sinkhorn-Knopp WMD solvers (port of the parts of
``repro.core.sinkhorn`` the engine uses; the dense solvers are not ported
yet).

Conventions: ``lam`` is the positive regularization strength and the
kernel is ``K = exp(-lam * M)``.
"""
from __future__ import annotations

import numpy as np
import torch

# ln(fp32 min normal) ~ -87.3: exp(-x) flushes to exactly 0 beyond this,
# and an all-zero gathered K column turns the Sinkhorn 1/(K^T u) line into
# inf/NaN for every document containing that word.
MAX_NEG_EXP = 87.0


class LamUnderflowError(FloatingPointError):
    """``K = exp(-lam*M)`` underflowed to all-zero for some corpus word.

    Raised by the engine instead of returning NaN distances."""


def underflow_report(lam: float, vecs_sel, vecs, docs) -> str:
    """Host-side diagnosis for :class:`LamUnderflowError` (error path only):
    the corpus words whose K column is all-zero — words farther than
    ``MAX_NEG_EXP / lam`` from every query word — and the documents that
    hold one."""
    a = _np64(vecs_sel)
    b = _np64(vecs)
    d2 = (np.sum(a * a, 1)[:, None] + np.sum(b * b, 1)[None, :]
          - 2.0 * (a @ b.T))
    mincol = np.sqrt(np.maximum(d2, 0.0)).min(axis=0)     # (V,) to nearest
    dead = lam * mincol > MAX_NEG_EXP                     # query word
    idx = _np(docs.idx)
    live = _np(docs.val) > 0
    hit = dead[idx] & live
    n_docs = int(hit.any(axis=1).sum())
    scale = float(np.median(mincol[np.isfinite(mincol)]))
    return (
        f"K = exp(-lam*M) underflowed to an all-zero column for "
        f"{int(dead[np.unique(idx[hit])].size)} corpus word(s) in {n_docs} "
        f"document(s) at lam={lam:g} (fp32 cutoff: lam*dist > ~{MAX_NEG_EXP:.0f}; "
        f"max lam*min-dist here = {lam * float(mincol.max()):.0f}). The "
        f"Sinkhorn division by these columns would make every affected "
        f"distance NaN. Reduce lam (corpus min-distance scale ~{scale:.1f} "
        f"-> lam <~ {MAX_NEG_EXP / max(scale, 1e-9):.1f}), or opt into the "
        f"log-domain solve — precision='log' on WmdEngine (underflow-free "
        f"at any lam)."
    )


def cdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise Euclidean distance, GEMM-shaped (paper §6):
    ``m[i, j] = sqrt(|a_i|^2 + |b_j|^2 - 2 a_i.b_j)``."""
    a2 = (a * a).sum(-1)[:, None]
    b2 = (b * b).sum(-1)[None, :]
    return torch.sqrt(torch.clamp(a2 + b2 - 2.0 * (a @ b.T), min=0.0))


def select_support(r_full, vecs, dtype=np.float32):
    """Host-side support selection (paper: ``sel = r.squeeze() > 0``).
    Returns numpy (r_sel, vecs_sel, idx)."""
    r_full = _np(r_full).reshape(-1)
    idx = np.nonzero(r_full > 0)[0]
    r_sel = r_full[idx].astype(dtype)
    r_sel = r_sel / r_sel.sum()
    return r_sel, _np(vecs)[idx].astype(dtype), idx


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _np64(a) -> np.ndarray:
    return _np(a).astype(np.float64)
