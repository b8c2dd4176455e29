"""Dense one-to-many Sinkhorn-Knopp WMD solver (paper Algorithm 1 / Fig. 2)
and the pieces every solver shares (port of ``repro.core.sinkhorn``).

``sinkhorn_wmd_dense`` is the paper-faithful baseline: dense (V, N)
GEMMs followed by the sparse elementwise selection, the formulation the
paper profiles in Table 1 before replacing it with sparse kernels
(:mod:`.sinkhorn_sparse`). Its products are plain ``torch.matmul``: the
reference leaves them to XLA, outside any Pallas kernel.

Shapes follow the paper: V vocabulary, v_r unique query words, N target
documents, w embedding width. ``lam`` is the positive regularization
strength and the kernel is ``K = exp(-lam * M)``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# ln(fp32 min normal) ~ -87.3: exp(-x) flushes to exactly 0 beyond this,
# and an all-zero gathered K column turns the Sinkhorn 1/(K^T u) line into
# inf/NaN for every document containing that word.
MAX_NEG_EXP = 87.0


class LamUnderflowError(FloatingPointError):
    """``K = exp(-lam*M)`` underflowed to all-zero for some corpus word.

    Raised by the engine and ``one_to_many`` instead of returning NaN
    distances."""


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
        f"log-domain solve — precision='log' on WmdEngine / "
        f"sinkhorn_wmd_sparse (underflow-free at any lam), or "
        f"impl='dense_stabilized' for the dense path."
    )


def cdist(a: torch.Tensor, b: torch.Tensor, gemm_dtype=None) -> torch.Tensor:
    """Pairwise Euclidean distance, GEMM-shaped (paper §6):
    ``m[i, j] = sqrt(|a_i|^2 + |b_j|^2 - 2 a_i.b_j)``.

    ``gemm_dtype`` (``torch.bfloat16``) rounds ONLY the product's operands;
    the products and sums stay fp32, as the reference's
    ``preferred_element_type=float32`` keeps them (a product of two bf16
    values is exact in fp32)."""
    a2 = (a * a).sum(-1)[:, None]
    b2 = (b * b).sum(-1)[None, :]
    ab = gemm_round(a, gemm_dtype) @ gemm_round(b, gemm_dtype).T
    return torch.sqrt(torch.clamp(a2 + b2 - 2.0 * ab, min=0.0))


def gemm_round(a: torch.Tensor, gemm_dtype) -> torch.Tensor:
    """``a`` rounded to ``gemm_dtype`` and back to fp32 (identity for
    ``None``): the bf16 operand policy with fp32 arithmetic."""
    return a if gemm_dtype is None else a.to(gemm_dtype).to(a.dtype)


class SinkhornPrecompute(NamedTuple):
    """Loop-invariant matrices (paper: "can be pre-computed once and
    reused")."""

    M: torch.Tensor          # (v_r, V) transport cost
    K: torch.Tensor          # (v_r, V) exp(-lam*M)
    K_over_r: torch.Tensor   # (v_r, V) diag(1/r) K
    KM: torch.Tensor         # (v_r, V) K * M


def precompute(r: torch.Tensor, vecs_sel: torch.Tensor, vecs: torch.Tensor,
               lam: float) -> SinkhornPrecompute:
    """M, K, K_over_r and KM for the selected query words: ``r`` (v_r,)
    normalized frequencies, ``vecs_sel`` (v_r, w) their embeddings,
    ``vecs`` (V, w) the vocabulary."""
    m = cdist(vecs_sel, vecs)
    k = torch.exp(-lam * m)
    return SinkhornPrecompute(M=m, K=k, K_over_r=k / r[:, None], KM=k * m)


def sinkhorn_wmd_dense(r: torch.Tensor, vecs_sel: torch.Tensor,
                       vecs: torch.Tensor, c: torch.Tensor, lam: float,
                       n_iter: int) -> torch.Tensor:
    """Paper Fig. 2, dense: WMD of one query against N target documents.
    ``c`` (V, N) is the column-normalized word-frequency matrix of the
    targets, dense. Returns wmd (N,)."""
    pre = precompute(r, vecs_sel, vecs, lam)
    v_r = r.shape[0]
    x = torch.full((v_r, c.shape[1]), 1.0 / v_r, dtype=pre.K.dtype,
                   device=c.device)
    kt = pre.K.T
    for _ in range(n_iter):
        u = 1.0 / x
        # Table 1 hot line: v = c.multiply(1 / (K.T @ u))  (91.9% of runtime)
        v = c * (1.0 / (kt @ u))                 # (V, N) dense GEMM
        x = pre.K_over_r @ v                     # (v_r, N) "SpMM" line
    u = 1.0 / x
    v = c * (1.0 / (kt @ u))
    return (u * (pre.KM @ v)).sum(0)


def sinkhorn_wmd_dense_stabilized(r: torch.Tensor, vecs_sel: torch.Tensor,
                                  vecs: torch.Tensor, c: torch.Tensor,
                                  lam: float, n_iter: int) -> torch.Tensor:
    """Log-domain Sinkhorn (fp32-safe at large ``lam``): dual potentials f
    (v_r, N) and g (V, N) replace the scaling vectors and logsumexp
    reductions over a (v_r, V, N) tensor replace the products. Solves the
    same fixed point, P = diag(exp(f)) K diag(exp(g)). Returns wmd (N,).
    The (v_r, V, N) temporaries make it a small-N tool."""
    m = cdist(vecs_sel, vecs)                    # (v_r, V)
    log_r = torch.log(r)
    live = c > 0
    neg_inf = torch.tensor(-float("inf"), dtype=m.dtype, device=m.device)
    log_c = torch.where(live, torch.log(torch.where(live, c, 1.0)), neg_inf)
    lm = (-lam * m)[:, :, None]                  # (v_r, V, 1)
    f = torch.zeros((r.shape[0], c.shape[1]), dtype=m.dtype, device=m.device)
    g = torch.zeros_like(c)
    for _ in range(n_iter):
        # column marginal: logsumexp over query words
        g = log_c - torch.logsumexp(lm + f[:, None, :], dim=0)     # (V, N)
        g = torch.where(torch.isneginf(log_c), neg_inf, g)
        # row marginal: logsumexp over the vocabulary
        f = log_r[:, None] - torch.logsumexp(lm + g[None], dim=1)  # (v_r, N)
    # transport plan P[k, i, n] = exp(f + g - lam*M); WMD = <P, M>
    p = torch.exp(f[:, None, :] + g[None] + lm)
    return (p * m[:, :, None]).sum(dim=(0, 1))


def select_support(r_full, vecs, dtype=np.float32):
    """Support selection (paper: ``sel = r.squeeze() > 0``). Returns
    (r_sel, vecs_sel, idx) with ``idx`` a numpy array of the query's word
    ids. For numpy ``vecs`` the first two are numpy; for a tensor they are
    tensors on ``vecs``' device, and only the support rows are gathered
    there: the (V, w) table never leaves the device."""
    r_full = _np(r_full).reshape(-1)
    idx = np.nonzero(r_full > 0)[0]
    r_sel = r_full[idx].astype(dtype)
    r_sel = r_sel / r_sel.sum()
    table = torch.as_tensor(vecs)
    rows = torch.as_tensor(idx, device=table.device)
    sel = table.index_select(0, rows).to(torch.from_numpy(r_sel).dtype)
    if not isinstance(vecs, torch.Tensor):
        return r_sel, sel.numpy(), idx
    return torch.as_tensor(r_sel, device=table.device), sel, idx


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _np64(a) -> np.ndarray:
    return _np(a).astype(np.float64)
