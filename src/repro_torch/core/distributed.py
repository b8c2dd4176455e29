"""Sinkhorn-WMD over a mesh of positions: the paper's parallelization
split across devices (port of ``repro.core.distributed``).

The reference runs its per-chip bodies under ``shard_map``; the port keeps
its single-controller model: one process walks the mesh's positions
(:class:`~repro_torch.runtime.sharding.CorpusMesh`, positions may repeat a
device), each position's body runs plain torch on its own device, and
each ``shard_map`` collective is one counted host-driven collective of
:mod:`repro_torch.runtime.sharding`. As in the reference, no kernel lives
here: the per-position loop is einsum.

``dense`` (the paper-faithful distributed baseline)
    The vocabulary V is split over the ``"model"`` axis and the documents
    N over the other (data) axes. Per iteration Kᵀu and the c-mask are
    local; the contraction over V crosses the split: one ``psum`` of a
    (v_r, N_local) tile over ``"model"`` per iteration.

``sparse`` (the production path)
    After the precompute the ELL iteration touches only per-document
    state, so documents are split over every position and the loop runs
    with no collective. ``vshard_precompute=False`` computes the full
    (v_r, V) cdist at every position; ``True`` splits it over ``"model"``
    and assembles G with one ``psum_scatter`` before the loop. Under
    ``tol`` the loop's one collective is a (Q,) ``pmax`` per check.

Load balance across positions (the paper's nnz binary search) is handled
at ingest by :func:`repro_torch.data.corpus.shard_balanced`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.runtime.sharding import (CorpusMesh, pmax, psum,
                                          psum_scatter)

from .sinkhorn import LamUnderflowError, cdist, underflow_report
from .sinkhorn_sparse import (adaptive_loop_scoped,
                              marginal_residual_per_query, reconstruct_gm)
from .sparse import PaddedDocs


def _data_index(mesh: CorpusMesh) -> list:
    """(data block, model block) of each position: the data block ravels
    the coordinates off ``"model"`` in axis order."""
    mi = mesh.axis_names.index("model") if "model" in mesh.axis_names \
        else None
    out = []
    for c in mesh.coords():
        d = 0
        for i, (v, n) in enumerate(zip(c, mesh.shape)):
            if i != mi:
                d = d * n + v
        out.append((d, 0 if mi is None else c[mi]))
    return out


def _n_model(mesh: CorpusMesh) -> int:
    return (mesh.axis_size("model") if "model" in mesh.axis_names else 1)


def _tensor(a, dtype) -> torch.Tensor:
    return torch.as_tensor(a).to(dtype)


def _split(n: int, parts: int, what: str) -> int:
    if n % parts:
        raise ValueError(f"{what}: {n} does not split over {parts} "
                         "positions")
    return n // parts


# --------------------------------------------------------------------------
# dense distributed (the paper-faithful baseline)
# --------------------------------------------------------------------------

def sinkhorn_wmd_dense_distributed(r, vecs_sel, vecs, c, lam: float,
                                   n_iter: int, mesh: CorpusMesh):
    """Dense Alg. 1 with V over ``"model"`` and N over the data axes.

    Inputs: r (v_r,), vecs_sel (v_r, w), vecs (V, w), c (V, N) as numpy
    arrays or tensors; V must split over the ``"model"`` axis and N over
    the data axes. Returns wmd (N,) on the mesh's first device."""
    r, sel = _tensor(r, torch.float32), _tensor(vecs_sel, torch.float32)
    vecs, c = _tensor(vecs, torch.float32), _tensor(c, torch.float32)
    n_model = _n_model(mesh)
    n_data = mesh.size // n_model
    v_loc = _split(vecs.shape[0], n_model, "dense: vocabulary")
    n_loc = _split(c.shape[1], n_data, "dense: documents")
    blocks = _data_index(mesh)
    state = []
    for dev, (d, m) in zip(mesh.devices, blocks):
        mv = cdist(sel.to(dev), vecs[m * v_loc:(m + 1) * v_loc].to(dev))
        k = torch.exp(-lam * mv)
        state.append((k, k / r.to(dev)[:, None], k * mv,
                      c[m * v_loc:(m + 1) * v_loc,
                        d * n_loc:(d + 1) * n_loc].to(dev)))
    v_r = sel.shape[0]
    xs = [torch.full((v_r, n_loc), 1.0 / v_r, dtype=torch.float32,
                     device=dev) for dev in mesh.devices]
    for _ in range(n_iter):
        parts = []
        for (k, k_over_r, _, c_loc), x in zip(state, xs):
            v = c_loc * (1.0 / (k.T @ (1.0 / x)))      # (V_loc, N_loc)
            parts.append(k_over_r @ v)
        # the contraction over V crosses the model split: one psum
        xs = psum(mesh, parts, "model")
    parts = []
    for (k, _, km, c_loc), x in zip(state, xs):
        u = 1.0 / x
        v = c_loc * (1.0 / (k.T @ u))
        parts.append(torch.sum(u * (km @ v), dim=0))
    outs = psum(mesh, parts, "model")
    first = {}
    for p, (d, _) in enumerate(blocks):
        first.setdefault(d, p)
    dev0 = mesh.devices[0]
    return torch.cat([outs[first[d]].to(dev0) for d in range(n_data)])


# --------------------------------------------------------------------------
# sparse distributed (the production path)
# --------------------------------------------------------------------------

def _check_underflow(out, lam, vecs_sel, vecs, docs,
                     mesh: CorpusMesh | None = None, doc_ids=None):
    """Host-side lam guard of the distributed solvers: a K underflow
    poisons the affected positions' distances with NaN; raise the engine's
    diagnosed :class:`LamUnderflowError` instead. With ``mesh`` the report
    names the OWNING SHARD(S) of the poisoned doc positions (docs are dealt
    to positions in contiguous blocks, so ownership is position // block),
    and with ``doc_ids`` it quotes those EXTERNAL doc ids instead of
    storage positions."""
    out_np = out.detach().cpu().numpy()
    if vecs_sel.shape[0] == 0 or not np.isnan(out_np).any():
        return out
    sel2 = vecs_sel.reshape(-1, vecs_sel.shape[-1])
    msg = underflow_report(lam, sel2, vecs, docs)
    nan_docs = np.nonzero(np.isnan(out_np).any(axis=0) if out_np.ndim == 2
                          else np.isnan(out_np))[0]
    if nan_docs.size:
        ids = (np.asarray(doc_ids)[nan_docs] if doc_ids is not None
               else nan_docs)
        shown = ids[:8].tolist()
        tail = ", ..." if ids.size > 8 else ""
        kind = "external doc ids" if doc_ids is not None else "doc positions"
        where = f"{nan_docs.size} poisoned docs ({kind} {shown}{tail})"
        if mesh is not None:
            block = max(1, out_np.shape[-1] // mesh.size)
            owners = sorted({int(d // block) for d in nan_docs})
            shape = dict(zip(mesh.axis_names, mesh.shape))
            where = (f"owning shard(s) {owners} of {mesh.size} on mesh "
                     f"{shape}; " + where)
        msg = f"{where} — {msg}"
    raise LamUnderflowError(msg)


def sinkhorn_wmd_sparse_distributed(r, vecs_sel, vecs, docs: PaddedDocs,
                                    lam: float, n_iter: int,
                                    mesh: CorpusMesh,
                                    vshard_precompute: bool = True,
                                    check_underflow: bool = True,
                                    tol: float | None = None,
                                    check_every: int = 4, qmask=None,
                                    return_iters: bool = False,
                                    doc_ids=None):
    """ELL fused Sinkhorn with the docs split over every mesh position.

    ``vshard_precompute=False``: every position computes the full
    (v_r, V) cdist and gathers its docs' columns (replicated compute, no
    collective). ``True``: the cdist is split over ``"model"`` (each
    position owns V/model vocabulary columns), each position gathers the
    columns it owns for the docs of its data block, and one
    ``psum_scatter`` over ``"model"`` sums the contributions and deals each
    model position its slice of those docs; GM is rebuilt from the
    assembled G, so it never crosses. N must split over the positions (and
    V over ``"model"`` with vshard).

    Batched queries: ``r`` (Q, v_r) with ``vecs_sel`` (Q, v_r, w) solves
    all Q against the shared docs and returns (Q, N); ``qmask`` (Q, v_r)
    marks live support rows (padded rows: ``r == 1``, ``qmask == 0``).

    ``tol`` enables the adaptive loop
    (:func:`~repro_torch.core.sinkhorn_sparse.adaptive_loop_scoped`): every
    ``check_every`` iterations each position reduces its residual per
    query and one (Q,) ``pmax`` over the mesh agrees on it, so every
    position freezes the same queries at the same check.
    ``return_iters=True`` also returns the per-query realized counts ((Q,)
    int32; (1,) for a single query). NaN distances from a K underflow
    raise :class:`LamUnderflowError` (``check_underflow=False`` opts out;
    the check syncs); ``doc_ids`` (N,) names each doc position's external
    id in that report. Returns the distances on the mesh's first
    device."""
    batched = np.ndim(r) == 2
    r = _tensor(r, torch.float32)
    sel = _tensor(vecs_sel, torch.float32)
    vecs = _tensor(vecs, torch.float32)
    idx = _tensor(docs.idx, torch.int64)
    val = _tensor(docs.val, torch.float32)
    rq = r if batched else r.reshape(1, -1)
    sel2 = sel.reshape(-1, sel.shape[-1])
    n_docs, length = idx.shape
    blocks = _data_index(mesh)
    gs, vals = [], []
    if not vshard_precompute:
        n_loc = _split(n_docs, mesh.size, "sparse: documents")
        for p, dev in enumerate(mesh.devices):
            k = torch.exp(-lam * cdist(sel2.to(dev), vecs.to(dev)))
            idx_p = idx[p * n_loc:(p + 1) * n_loc].to(dev)
            g = k.index_select(1, idx_p.reshape(-1))
            gs.append(g.reshape(rq.shape + (n_loc, length)))
            vals.append(val[p * n_loc:(p + 1) * n_loc].to(dev))
        order = list(range(mesh.size))
    else:
        n_model = _n_model(mesh)
        v_loc = _split(vecs.shape[0], n_model, "sparse: vocabulary")
        n_data = _split(n_docs, mesh.size // n_model, "sparse: documents")
        n_slice = _split(n_data, n_model, "sparse: data block")
        parts = []
        for dev, (d, m) in zip(mesh.devices, blocks):
            k = torch.exp(-lam * cdist(
                sel2.to(dev), vecs[m * v_loc:(m + 1) * v_loc].to(dev)))
            rel = idx[d * n_data:(d + 1) * n_data].to(dev) - m * v_loc
            mine = (rel >= 0) & (rel < v_loc)
            rel = torch.where(mine, rel, 0)
            g = k.index_select(1, rel.reshape(-1)).reshape(
                -1, n_data, length)
            parts.append(torch.where(mine[None], g, 0.0))
        # assemble G and deal the docs over the model axis: one collective
        parts = psum_scatter(mesh, parts, "model", dim=1)
        for p, (dev, (d, m)) in enumerate(zip(mesh.devices, blocks)):
            lo = d * n_data + m * n_slice
            gs.append(parts[p].reshape(rq.shape + (n_slice, length)))
            vals.append(val[lo:lo + n_slice].to(dev))
        order = sorted(range(mesh.size), key=lambda p: blocks[p])
    outs, iters = _ell_loop(mesh, rq, gs, vals, lam, n_iter, tol=tol,
                            check_every=check_every, qmask=qmask)
    dev0 = mesh.devices[0]
    out = torch.cat([outs[p].to(dev0) for p in order], dim=1)
    if not batched:
        out = out[0]
    if check_underflow:
        _check_underflow(out, lam, sel, vecs, PaddedDocs(idx=idx, val=val),
                         mesh=mesh, doc_ids=doc_ids)
    return (out, iters) if return_iters else out


def _ell_loop(mesh: CorpusMesh, r, gs, vals, lam, n_iter, tol=None,
              check_every: int = 4, qmask=None):
    """The fused SDDMM_SpMM iteration at every position, in lockstep.

    ``r`` (Q, v_r); ``gs`` one (Q, v_r, N_p, L) G block per position on its
    device, ``vals`` its (N_p, L) ELL weights. Returns (one (Q, N_p) wmd
    per position, (Q,) realized iterations). The fixed loop is
    collective-free; under ``tol`` it is
    :func:`~repro_torch.core.sinkhorn_sparse.adaptive_loop_scoped` whose
    one collective is the (Q,) residual ``pmax`` over the mesh per check,
    so every position freezes the same queries at the same iteration."""
    q, v_r = r.shape
    dev0 = mesh.devices[0]
    pos = []
    for g, val in zip(gs, vals):
        dev = g.device
        g_over_r = g / r.to(dev)[:, :, None, None]
        qm = None
        if qmask is not None:
            # padded support rows are inert: G rows zeroed, u rows masked
            qm = _tensor(qmask, torch.float32).to(dev)
            g = g * qm[:, :, None, None]
            g_over_r = g_over_r * qm[:, :, None, None]
        pos.append((g, g_over_r, val, val > 0, qm))
    n_live = (_tensor(qmask, torch.float32).to(dev0).sum(dim=1)
              if qmask is not None
              else torch.full((q,), float(v_r), device=dev0))
    x0 = 1.0 / torch.clamp(n_live, min=1.0)
    xs = []
    for g, _, _, _, qm in pos:
        x = x0.to(g.device)[:, None, None].expand(q, v_r, g.shape[2])
        x = x.to(g.dtype).contiguous()
        xs.append(x * qm[:, :, None] if qm is not None else x)

    def u_of(x, qm):
        if qm is None:
            return 1.0 / x      # raw: a K underflow must surface as NaN
        keep = qm[:, :, None] > 0
        return torch.where(keep, 1.0 / torch.where(keep, x, 1.0), 0.0)

    def step(xs, active=None):
        new_x, new_w = [], []
        for (g, g_over_r, val, live, qm), x in zip(pos, xs):
            u = u_of(x, qm)
            if active is not None:
                # frozen queries' update rows are dropped via the u mask
                u = u * active.to(g.device)[:, None, None].to(g.dtype)
            t = torch.einsum("qknl,qkn->qnl", g, u)
            w = torch.where(live[None], val[None] / t, 0.0)
            new_x.append(torch.einsum("qknl,qnl->qkn", g_over_r, w))
            new_w.append(w)
        return new_x, new_w

    if tol is None:
        for _ in range(n_iter):
            xs, _ = step(xs)
        iters = torch.full((q,), n_iter, dtype=torch.int32, device=dev0)
    else:
        live_q = (_tensor(qmask, torch.float32).to(dev0).sum(dim=1) > 0
                  if qmask is not None
                  else torch.ones((q,), dtype=torch.bool, device=dev0))
        masks = [live[None].expand((q,) + live.shape)
                 for _, _, _, live, _ in pos]

        def residual(ws, wps):
            return [marginal_residual_per_query(w, wp, m)
                    for w, wp, m in zip(ws, wps, masks)]

        def all_reduce(res):
            # the loop's one collective: every position freezes the same
            # queries at the same check
            return pmax(mesh, res, mesh.axis_names)[0].to(dev0)

        xs, iters = adaptive_loop_scoped(step, residual, xs, n_iter, tol,
                                         check_every, live_q,
                                         all_reduce=all_reduce)
    outs = []
    for (g, _, val, live, qm), x in zip(pos, xs):
        u = u_of(x, qm)
        t = torch.einsum("qknl,qkn->qnl", g, u)
        w = torch.where(live[None], val[None] / t, 0.0)
        outs.append(torch.einsum("qkn,qknl,qnl->qn", u,
                                 reconstruct_gm(g, lam), w))
    return outs, iters


def sharded_inputs(mesh: CorpusMesh, r, vecs_sel, vecs, docs: PaddedDocs,
                   for_impl: str = "sparse") -> dict:
    """The solvers' inputs as tensors on the mesh's first device, where
    the controller cuts each position's block from (the reference
    ``device_put``\\ s them with the shardings its ``shard_map`` expects).
    ``for_impl="sparse"`` adds ``docs``; the dense solver takes its c
    matrix as it is."""
    dev = mesh.devices[0]

    def put(a, dtype):
        return torch.as_tensor(a).to(device=dev, dtype=dtype)

    out = dict(r=put(r, torch.float32), vecs_sel=put(vecs_sel, torch.float32),
               vecs=put(vecs, torch.float32))
    if for_impl == "sparse":
        out["docs"] = PaddedDocs(idx=put(docs.idx, torch.int64),
                                 val=put(docs.val, torch.float32))
    return out
