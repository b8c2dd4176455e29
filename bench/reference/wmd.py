"""The plain reference: Word Mover's Distance by Sinkhorn-Knopp in the log
domain, dense, in plain PyTorch, in float64.

It computes what arXiv:2005.06727's Algorithm 1 (Fig. 2) computes for
one query r (v words, frequencies r_i, embeddings a_i) against a document
c (n words, frequencies c_j, embeddings b_j), with M_ij = |a_i - b_j| and
K = exp(-lam M):

    x = 1/v;  n_iter times: u = 1/x, w = c / (K^T u), x = diag(1/r) K w
    u = 1/x,  w = c / (K^T u),  WMD = sum_ij u_i K_ij M_ij w_j

Every product and quotient is carried as a logarithm (log-sum-exp for
the two contractions), so K never underflows at any lam. It knows
nothing of the program: no index, groups, clusters or kernels. It reads
only the embeddings, documents and queries the benchmark made.

The reference computes in float64 so that its own rounding lies far
below the program's fp32: the distance of a word to itself, which fp32's
|a|^2 + |b|^2 - 2ab leaves at ~1e-3 instead of 0, and the fp32 sums of
log-kernel values near -250, each move a distance by ~1e-5 of itself.

``tf32=True`` is the control of the correctness check, the reference
computed in the precision below the configuration's fp32 with TF32 off:
float32 throughout, and the distance product's operands rounded to TF32
(10 mantissa bits, as the tensor cores take them) with fp32 sums.
"""
from __future__ import annotations

import numpy as np
import torch

# elements of one (docs, v, L) block
BLOCK_ELEMS = 1 << 24


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (fp32) rounded to the nearest TF32 value (19 bits kept)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def distances(a: torch.Tensor, b: torch.Tensor,
              tf32: bool = False) -> torch.Tensor:
    """(v, w) x (V, w) -> (v, V) Euclidean distances in ``a``'s dtype."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        pa, pb = (round_tf32(a), round_tf32(b)) if tf32 else (a, b)
        ab = pa @ pb.T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    d2 = (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :] - 2.0 * ab
    return torch.sqrt(torch.clamp(d2, min=0.0))


def wmd_one_to_all(q_ids: np.ndarray, q_w: np.ndarray, vecs: torch.Tensor,
                   idx: np.ndarray, val: np.ndarray, lam: float,
                   n_iter: int, tf32: bool = False) -> np.ndarray:
    """WMD of one query (word ids, frequencies) to every document of the
    ELL arrays ``idx``/``val`` (N, L) (pad slots have val 0). Returns (N,)
    float64 on the host. Documents go in blocks of similar length. The
    frequencies are normalised here, in the reference's own dtype."""
    dev = vecs.device
    dtype = torch.float32 if tf32 else torch.float64
    table = vecs.to(dtype)
    m_all = distances(table[torch.as_tensor(q_ids, device=dev)], table,
                      tf32)                                   # (v, V)
    v = m_all.shape[0]
    w = torch.as_tensor(q_w, device=dev).to(dtype)
    log_r = torch.log(w / w.sum())
    nnz = (val > 0).sum(1)
    order = np.argsort(nnz, kind="stable")
    out = np.empty(idx.shape[0], np.float64)
    lo = 0
    while lo < order.size:
        width = max(1, int(nnz[order[min(order.size - 1, lo)]]))
        hi = lo
        while hi < order.size:       # grow the block while it fits
            width = max(width, int(nnz[order[hi]]))
            if (hi - lo + 1) * v * width > BLOCK_ELEMS and hi > lo:
                break
            hi += 1
        blk = order[lo:hi]
        width = max(1, int(nnz[blk].max()))
        out[blk] = _solve_block(
            m_all, log_r, torch.as_tensor(idx[blk, :width], dtype=torch.int64,
                                          device=dev),
            torch.as_tensor(val[blk, :width], device=dev).to(dtype), lam,
            n_iter)
        lo = hi
    return out


def _solve_block(m_all, log_r, idx, val, lam: float, n_iter: int):
    """Algorithm 1 in logarithms for a block of documents: m_all (v, V),
    log_r (v,), idx/val (n, L) -> (n,) distances."""
    v = m_all.shape[0]
    m = m_all[:, idx].permute(1, 0, 2)                        # (n, v, L)
    log_k = -lam * m
    live = val > 0
    val = val / val.sum(1, keepdim=True)
    log_c = torch.where(live, torch.log(torch.where(live, val, 1.0)),
                        torch.full_like(val, -float("inf")))  # (n, L)
    log_u = torch.full(m.shape[:2], float(np.log(v)), dtype=m.dtype,
                       device=m.device)

    def half(log_u):            # w = c / (K^T u)
        t = torch.logsumexp(log_k + log_u[:, :, None], dim=1)  # (n, L)
        return torch.where(live, log_c - t, log_c)

    for _ in range(n_iter):
        log_w = half(log_u)
        log_x = torch.logsumexp(log_k + log_w[:, None, :], dim=2) \
            - log_r[None, :]                                   # (n, v)
        log_u = -log_x
    log_w = half(log_u)
    plan = torch.exp(log_u[:, :, None] + log_k + log_w[:, None, :])
    return (plan * m).sum(dim=(1, 2)).double().cpu().numpy()
