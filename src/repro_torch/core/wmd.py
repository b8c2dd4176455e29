"""End-to-end Word Mover's Distance pipeline (public API; port of
``repro.core.wmd``).

    wmd = one_to_many(query_counts, corpus_docs, vecs, lam=..., n_iter=...,
                      impl="kernel")
    res = search(queries, corpus_docs, vecs, k=10, impl="kernel")

Implementations (the same distances, tested against each other and
against the exact-LP oracle):

  dense             paper Fig. 2 transliteration (the "python" baseline)
  dense_stabilized  log-domain dense (large-lam safe in fp32)
  sparse            fused SDDMM_SpMM formulation, gather-once (paper §4)
  sparse_unfused    separate SDDMM / SpMM with per-iteration gathers
                    (paper Fig. 3 before fusion; the fusion ablation)
  kernel            the Hopper kernels: cdist_exp -> gather ->
                    sinkhorn_fused_all

Everything runs on ``device`` (``cuda`` unless the caller asks for the
CPU, where the kernels' plain versions run). Top-k retrieval and the
batched many-query path go through :class:`~.index.WmdEngine` with its
einsum impl (``impl="sparse"``, the default here as in the reference) or
its kernel impl.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .sinkhorn import (LamUnderflowError, select_support, sinkhorn_wmd_dense,
                       sinkhorn_wmd_dense_stabilized, underflow_report)
from .sinkhorn_sparse import sinkhorn_wmd_sparse, sinkhorn_wmd_sparse_unfused
from .sparse import PaddedDocs, padded_docs_to_dense

IMPLS = ("dense", "dense_stabilized", "sparse", "sparse_unfused", "kernel")


def _on(a, dev: torch.device, dtype) -> torch.Tensor:
    """``a`` as a tensor on ``dev``; a tensor already there is not copied."""
    return torch.as_tensor(a, device=dev).to(dtype)


def one_to_many(r_full, docs: PaddedDocs, vecs, lam: float = 10.0,
                n_iter: int = 15, impl: str = "sparse",
                check_underflow: bool = True, device=None) -> torch.Tensor:
    """WMD from one query (full-vocab count/frequency vector ``r_full``) to
    every document in ``docs``. Returns (N,) distances on ``device``.

    ``vecs`` and the fields of ``docs`` may be numpy arrays or tensors;
    what is already on ``device`` is not moved, and numpy ``vecs`` are
    uploaded once per call.

    ``check_underflow`` (all impls but ``dense_stabilized``): raise
    :class:`LamUnderflowError` with a diagnosis when ``K = exp(-lam*M)``
    underflowed and the distances came out NaN, instead of returning them.
    The check syncs the result — pass ``False`` to keep the launch async.
    """
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    dev = resolve_device(device)
    vecs = _on(vecs, dev, torch.float32)
    docs = PaddedDocs(idx=_on(docs.idx, dev, torch.int64),
                      val=_on(docs.val, dev, torch.float32))
    r, vecs_sel, _ = select_support(r_full, vecs)

    if impl == "sparse":
        # the check below covers this impl: skip the solver's own
        out = sinkhorn_wmd_sparse(r, vecs_sel, vecs, docs, lam, n_iter,
                                  check_underflow=False)
    elif impl == "sparse_unfused":
        out = sinkhorn_wmd_sparse_unfused(r, vecs_sel, vecs, docs, lam,
                                          n_iter)
    elif impl == "kernel":
        from repro_torch.kernels.ops import sinkhorn_wmd_kernel
        out = sinkhorn_wmd_kernel(r, vecs_sel, vecs, docs, lam, n_iter)
    else:
        c = padded_docs_to_dense(docs, vecs.shape[0])
        if impl == "dense_stabilized":
            return sinkhorn_wmd_dense_stabilized(r, vecs_sel, vecs, c, lam,
                                                 n_iter)
        out = sinkhorn_wmd_dense(r, vecs_sel, vecs, c, lam, n_iter)
    if (check_underflow and r.shape[0] > 0
            and bool(torch.isnan(out).any())):
        raise LamUnderflowError(underflow_report(lam, vecs_sel, vecs, docs))
    return out


def many_to_many(queries: list[np.ndarray], docs: PaddedDocs, vecs,
                 lam: float = 10.0, n_iter: int = 15, impl: str = "sparse",
                 batched: bool = True, device=None) -> list[torch.Tensor]:
    """Paper Fig. 6 workload: several source documents at once.

    ``batched=True`` with ``impl`` "sparse" or "kernel" goes through the
    batched multi-query engine with that impl (one index, one solve per
    power-of-two v_r bucket). Otherwise, and for the dense impls, it loops
    :func:`one_to_many` over the queries."""
    if batched and impl in ("sparse", "kernel"):
        from .index import WmdEngine, build_index
        engine = WmdEngine(build_index(docs, vecs, device=device), lam=lam,
                           n_iter=n_iter, impl=impl)
        out = engine.query_batch(queries)
        return [out[i] for i in range(out.shape[0])]
    return [one_to_many(q, docs, vecs, lam, n_iter, impl, device=device)
            for q in queries]


def search(queries, docs: PaddedDocs, vecs, k: int = 10, lam: float = 10.0,
           n_iter: int = 15, impl: str = "sparse", prune: object = "rwmd",
           device=None):
    """One-shot top-k retrieval through the staged pipeline: freeze an
    index, prune with an admissible lower bound, Sinkhorn-solve the
    survivors, rank, on the engine's ``impl`` ("sparse" or "kernel").
    Returns a :class:`~.index.SearchResult`. ``prune=None`` scores every
    document."""
    from .index import WmdEngine, build_index
    engine = WmdEngine(build_index(docs, vecs, device=device), lam=lam,
                       n_iter=n_iter, impl=impl)
    return engine.search(queries, k, prune=prune)
