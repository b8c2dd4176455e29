"""The port's adaptive and bf16 solve on the CPU (the kernels' plain
versions) against the reference: ``tol``/``check_every``, the residual
scope (``resmask``, ``doc_mask``, ``scope=``), ``iter_stats`` and
``precision="bf16"``/``"bf16+log"``.

Tolerances, each with its source (ROADMAP queue 3):

- ``K1_TOL``, the plain K1 against the Pallas kernel in interpret mode on
  the same G: the reference's own kernel tolerance
  (``tests/test_kernels.py``); measured ~2.5e-7 on the CPU.
- ``R2``: the engines make their K blocks with GEMMs that sum in
  different orders (P1), held at the reference's batched-vs-looped
  spread R2; on the dedup corpus P1 reaches 1.3e-3, which R2's
  atol carries.
- ``P3``: the port's K1 exits per document, the reference's per block of
  128 documents, which iterates a converged document on while its block
  mates converge. On the dedup corpus at lam=1, tol=1e-2 the two differ
  by up to 4.8e-2 relative (0.074 absolute), measured; with the
  reference run at ``block_n=1`` (a per-document exit) the gap falls to
  1.2e-3, P1's size (:func:`test_p3_gap_is_the_exit_granularity`). Held
  at 5e-2 relative, 1e-1 absolute.
"""
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax.numpy as jnp  # noqa: E402
from benchmarks.fig8_topk_prune import dedup_corpus as ref_dedup_corpus  # noqa: E402
from repro.core import sinkhorn_sparse as ref_ss  # noqa: E402
from repro.core.index import WmdEngine as RefEngine  # noqa: E402
from repro.core.index import build_index as ref_build_index  # noqa: E402
from repro.core.index import save_index  # noqa: E402
from repro.core.sinkhorn import select_support as ref_select  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch.core import sinkhorn_sparse as ss  # noqa: E402
from repro_torch.core.index import (WmdEngine, build_index,  # noqa: E402
                                    index_from_arrays)
from repro_torch.core.sparse import PaddedDocs  # noqa: E402
from repro_torch.data.corpus import make_corpus  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

K1_TOL = dict(rtol=5e-5, atol=5e-5)
R2 = dict(rtol=1e-3, atol=5e-3)
P3 = dict(rtol=5e-2, atol=1e-1)
# fig10's operating point (benchmarks/fig10_solve_adaptive.py) and its
# per-query scope point (PQ_*)
FIG10 = dict(lam=0.25, n_iter=15, tol=3e-2, check_every=2)
PQ = dict(lam=1.0, n_iter=60, tol=1e-2, check_every=2)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors: one intra-op thread runs them fastest, also when
    several test workers share the host. Restored when the module ends."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _carry(ref_index):
    """The port's CPU index carried across from the reference's, so both
    engines search the same storage order and doc groups."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "index.npz")
        save_index(ref_index, path)
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files}
    return index_from_arrays(arrays, device="cpu")


@pytest.fixture(scope="module")
def dedup():
    return ref_dedup_corpus(256, vocab=1024, embed_dim=32, seed=5)


@pytest.fixture(scope="module")
def dedup_indexes(dedup):
    """(reference index, the port's CPU index carried across from it)."""
    ref_index = ref_build_index(dedup.docs, dedup.vecs)
    return ref_index, _carry(ref_index)


@pytest.fixture(scope="module")
def small_indexes(small_corpus):
    ref_index = ref_build_index(small_corpus.docs, small_corpus.vecs)
    return ref_index, _carry(ref_index)


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _k1_inputs(rng, q_n=2, v_r=8, n=64, length=8):
    """tests/test_solve_adaptive.py's kernel inputs."""
    g = rng.uniform(0.05, 1.0, (q_n, v_r, n, length)).astype(np.float32)
    val = np.where(rng.random((n, length)) > 0.3, 0.7, 0.0)
    val[:, 0] = 1.0
    r = rng.uniform(0.1, 1.0, (q_n, v_r)).astype(np.float32)
    return g, val.astype(np.float32), r


def _pallas(g, val, r, lam, n_iter, **kw):
    wmd, iters = ref_ops.sinkhorn_fused_all_batched(
        jnp.asarray(g), jnp.asarray(val), jnp.asarray(r), lam, n_iter,
        interpret=True, with_iters=True, **kw)
    return np.asarray(wmd), np.asarray(iters)


# ------------------------------------------------------ the exit statistic
def test_marginal_residuals_match_reference(rng):
    w = rng.random((3, 5, 7)).astype(np.float32)
    wp = rng.random((3, 5, 7)).astype(np.float32)
    mask = rng.random((3, 5, 7)) > 0.4
    mask[1] = False                              # an empty scope: ratio 0
    got = ss.marginal_residual(*_t(w, wp, mask))
    want = ref_ss.marginal_residual(w, wp, mask)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-7)
    got_q = ss.marginal_residual_per_query(*_t(w, wp, mask)).numpy()
    want_q = np.asarray(ref_ss.marginal_residual_per_query(w, wp, mask))
    np.testing.assert_allclose(got_q, want_q, rtol=1e-7)
    assert got_q[1] == 0.0


def _toy_step(a):
    """x -> a*x + 1 per column (converging at rate a), w = x."""
    def step(x, active=None):
        nx = a * x + 1.0
        return nx, nx
    return step


@pytest.mark.parametrize("n_iter,tol,ce", [(15, 3e-2, 2), (60, 1e-3, 4),
                                           (1, 1e-2, 3), (9, 0.0, 4)])
def test_adaptive_loops_match_reference(n_iter, tol, ce):
    """Realized counts on 1 + k*check_every, the cap overshoot and the
    per-query freeze, against the reference's lax.while_loop drivers."""
    a = np.array([0.3, 0.6, 0.9], np.float32)[:, None]
    x0 = np.ones((3, 4), np.float32)
    live = np.array([True, True, False])
    mask = np.ones((3, 4), bool)

    def res(w, wp):
        return ss.marginal_residual(w, wp, torch.from_numpy(mask))

    x, it = ss.adaptive_loop(_toy_step(torch.from_numpy(a)), res,
                             torch.from_numpy(x0), n_iter, tol, ce)
    rx, rit = ref_ss.adaptive_loop(
        _toy_step(jnp.asarray(a)),
        lambda w, wp: ref_ss.marginal_residual(w, wp, mask), jnp.asarray(x0),
        n_iter, tol, ce)
    assert it == int(rit) and (it - 1) % ce == 0
    np.testing.assert_allclose(x.numpy(), np.asarray(rx), rtol=1e-6)

    def res_q(w, wp):
        return ss.marginal_residual_per_query(w, wp, torch.from_numpy(mask))

    xq, itq = ss.adaptive_loop_scoped(
        _toy_step(torch.from_numpy(a)), res_q, torch.from_numpy(x0), n_iter,
        tol, ce, torch.from_numpy(live))
    rxq, ritq = ref_ss.adaptive_loop_scoped(
        _toy_step(jnp.asarray(a)),
        lambda w, wp: ref_ss.marginal_residual_per_query(w, wp, mask),
        jnp.asarray(x0), n_iter, tol, ce, jnp.asarray(live))
    np.testing.assert_array_equal(itq.numpy(), np.asarray(ritq))
    np.testing.assert_allclose(xq.numpy(), np.asarray(rxq), rtol=1e-6)


# ------------------------------------------------------------- the kernels
def test_kernel_adaptive_matches_fixed(rng):
    """tol=0 never exits early: at n_iter = 1 + 2*check_every the adaptive
    solve runs to the cap and returns the fixed solve (1e-6, as the
    reference's test holds it); against the Pallas kernel at K1_TOL."""
    g, val, r = _k1_inputs(rng)
    base = ops.sinkhorn_fused_all_batched(*_t(g, val, r), 4.0, 9,
                                          block_n=32)
    capped, iters = ops.sinkhorn_fused_all_batched(
        *_t(g, val, r), 4.0, 9, block_n=32, tol=0.0, check_every=4,
        with_iters=True)
    assert iters.shape == (2, 2) and (iters.numpy() == 9).all()
    np.testing.assert_allclose(capped.numpy(), base.numpy(), rtol=1e-6,
                               atol=1e-6)
    want, want_iters = _pallas(g, val, r, 4.0, 9, block_n=32, tol=0.0,
                               check_every=4)
    np.testing.assert_array_equal(iters.numpy(), want_iters)
    np.testing.assert_allclose(capped.numpy(), want, **K1_TOL)


def test_kernel_pad_query_block_exits_first_check(rng):
    """An all-pad query's docs have nothing to converge: they stop at the
    first check (1 + check_every), as the reference's pad blocks do."""
    g, val, r = _k1_inputs(rng, q_n=1, n=32)
    g2 = np.concatenate([g, np.zeros_like(g)])
    r2 = np.concatenate([r, np.ones_like(r)])
    kw = dict(block_n=32, tol=1e-4, check_every=3)
    wmd, iters = ops.sinkhorn_fused_all_batched(*_t(g2, val, r2), 4.0, 20,
                                                with_iters=True, **kw)
    assert (iters.numpy()[1] == 4).all(), iters
    base = ops.sinkhorn_fused_all_batched(*_t(g, val, r), 4.0, 20,
                                          block_n=32)
    np.testing.assert_allclose(wmd.numpy()[:1], base.numpy(), rtol=1e-3,
                               atol=1e-4)
    want, want_iters = _pallas(g2, val, r2, 4.0, 20, **kw)
    np.testing.assert_array_equal(iters.numpy(), want_iters)
    np.testing.assert_allclose(wmd.numpy()[0], want[0], **K1_TOL)


def test_kernel_resmask_scoping(rng):
    """An all-ones scope is the unscoped solve, bit for bit; an empty
    scope stops query 1 at the first check and leaves query 0 as it was;
    the counts equal the Pallas kernel's."""
    g, val, r = _k1_inputs(rng)
    kw = dict(block_n=32, tol=1e-3, check_every=3, with_iters=True)
    base, it_b = ops.sinkhorn_fused_all_batched(*_t(g, val, r), 4.0, 40,
                                                **kw)
    ones, it_o = ops.sinkhorn_fused_all_batched(
        *_t(g, val, r), 4.0, 40, resmask=torch.ones((2, 64)), **kw)
    assert torch.equal(it_o, it_b) and torch.equal(ones, base)
    rm = np.ones((2, 64), np.float32)
    rm[1] = 0.0
    part, it_p = ops.sinkhorn_fused_all_batched(
        *_t(g, val, r), 4.0, 40, resmask=torch.from_numpy(rm), **kw)
    assert (it_p.numpy()[1] == 4).all(), it_p
    assert torch.equal(it_p[0], it_b[0]) and torch.equal(part[0], base[0])
    kw.pop("with_iters")
    for mask, got, got_it in ((None, base, it_b), (rm, part, it_p)):
        want, want_it = _pallas(g, val, r, 4.0, 40, resmask=mask, **kw)
        np.testing.assert_array_equal(got_it.numpy(), want_it)
        np.testing.assert_allclose(got.numpy()[0], want[0], **K1_TOL)


def _staged_g(eng, qs, grp):
    """(G, r) of the engine's first chunk against one doc group."""
    from repro_torch.core.index import _gather_g
    _, chunks = eng._plan(qs)
    chunk, width = chunks[0]
    sup, r, mask = eng._prep_chunk([qs[qi] for qi in chunk], width)
    return _gather_g(eng._kq(sup, mask)[0], grp.docs.idx), r, len(chunk)


def test_kernel_exit_is_per_doc(dedup_indexes, dedup):
    """The exit is per document: a doc takes the same count (block_n=1
    gives each doc's) in any launch and under any scope of its launch
    mates, so its distance does not depend on them (the staged search's
    exactness under tol rests on it; on the card bit for bit, here up to
    the plain version's summation order)."""
    _, index = dedup_indexes
    eng = WmdEngine(index, **PQ)
    grp = index.groups[0]
    g, r, _ = _staged_g(eng, list(dedup.queries[:1]), grp)
    val = grp.docs.val
    kw = dict(tol=PQ["tol"], check_every=2, block_n=1, with_iters=True)
    full, it_full = ops.sinkhorn_fused_all_batched(g, val, r, 1.0, 60, **kw)
    assert len(set(it_full[0].tolist())) > 1          # docs differ
    sub, it_sub = ops.sinkhorn_fused_all_batched(
        g[:, :, 10:20].contiguous(), val[10:20].contiguous(), r, 1.0, 60,
        **kw)
    assert torch.equal(it_sub, it_full[:, 10:20])
    np.testing.assert_allclose(sub.numpy(), full.numpy()[:, 10:20],
                               rtol=1e-6, atol=1e-7)
    rm = torch.zeros(full.shape)
    rm[:, 10:20] = 1.0
    scoped, it_sc = ops.sinkhorn_fused_all_batched(g, val, r, 1.0, 60,
                                                   resmask=rm, **kw)
    assert torch.equal(scoped[:, 10:20], full[:, 10:20])
    assert torch.equal(it_sc[:, 10:20], it_full[:, 10:20])
    assert (it_sc[:, :10] == 3).all()              # empty scope: one check


@pytest.mark.parametrize("log_domain", [False, True])
@pytest.mark.parametrize("tol", [None, 3e-2])
def test_kernel_bf16_matches_pallas(rng, log_domain, tol):
    """bf16 operands: the plain K1 rounds where the Pallas kernel does
    (round to nearest even), so the two agree at K1_TOL; bf16 against
    fp32 moves the distance by far more than that."""
    g, val, r = _k1_inputs(rng)
    if log_domain:
        g = np.log(g)
    kw = dict(block_n=32, log_domain=log_domain, tol=tol, check_every=2)
    got, it = ops.sinkhorn_fused_all_batched(*_t(g, val, r), 0.25, 15,
                                             gemm="bf16", with_iters=True,
                                             **kw)
    want, want_it = _pallas(g, val, r, 0.25, 15, gemm="bf16", **kw)
    np.testing.assert_allclose(got.numpy(), want, **K1_TOL)
    np.testing.assert_array_equal(it.numpy(), want_it)
    fp32 = ops.sinkhorn_fused_all_batched(*_t(g, val, r), 0.25, 15, **kw)
    assert float((fp32 - got).abs().max()) > 10 * K1_TOL["atol"]


@pytest.mark.parametrize("gemm", ["fp32", "bf16"])
def test_k4_adaptive_matches_pallas(rng, gemm):
    """K4 (one query) with tol, a resmask and both operand types."""
    g, val, r = _k1_inputs(rng, q_n=1, v_r=19, n=128, length=40)
    rm = (rng.random(128) > 0.5).astype(np.float32)
    kw = dict(block_n=64, tol=1e-2, check_every=3, gemm=gemm)
    got, it = ops.sinkhorn_fused_all(*_t(g[0], val, r[0]), 2.0, 30,
                                     resmask=torch.from_numpy(rm),
                                     with_iters=True, **kw)
    want, want_it = ref_ops.sinkhorn_fused_all(
        jnp.asarray(g[0]), jnp.asarray(val), jnp.asarray(r[0]), 2.0, 30,
        interpret=True, resmask=jnp.asarray(rm), with_iters=True, **kw)
    np.testing.assert_array_equal(it.numpy(), np.asarray(want_it))
    # the exit is per doc here and per block there: docs of a block that
    # converged before their block did stop earlier (P3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **P3)


def test_solver_options_are_checked(rng):
    g, val, r = _t(*_k1_inputs(rng))
    with pytest.raises(ValueError, match="check_every"):
        ops.sinkhorn_fused_all_batched(g, val, r, 1.0, 5, tol=1e-3,
                                       check_every=0)
    with pytest.raises(ValueError, match="resmask"):
        ops.sinkhorn_fused_all_batched(g, val, r, 1.0, 5, tol=1e-3,
                                       resmask=torch.ones(3))
    with pytest.raises(ValueError, match="gemm"):
        ops.sinkhorn_fused_all_batched(g, val, r, 1.0, 5, gemm="fp16")
    # without tol the scope is unused, as in the reference
    a = ops.sinkhorn_fused_all_batched(g, val, r, 1.0, 5)
    b = ops.sinkhorn_fused_all_batched(g, val, r, 1.0, 5,
                                       resmask=torch.zeros(2, 64))
    assert torch.equal(a, b)


# ------------------------------------------------------ the sparse solver
def _sparse_args(corpus, qi):
    r, sel, _ = ref_select(corpus.queries[qi], corpus.vecs)
    docs = PaddedDocs(idx=torch.from_numpy(np.asarray(corpus.docs.idx,
                                                      np.int64)),
                      val=torch.from_numpy(np.asarray(corpus.docs.val)))
    return ((r, sel, jnp.asarray(corpus.vecs), corpus.docs),
            (*_t(np.asarray(r), np.asarray(sel), corpus.vecs), docs))


@pytest.mark.parametrize("precision", ["fp32", "bf16", "log", "bf16+log"])
def test_sparse_solver_adaptive_matches_reference(dedup, precision):
    """sinkhorn_wmd_sparse(tol=...): the same realized count and the same
    distances (P1's size on the dedup corpus: R2) in every precision."""
    ref_args, args = _sparse_args(dedup, 0)
    kw = dict(tol=FIG10["tol"], check_every=FIG10["check_every"],
              precision=precision, return_iters=True)
    got, it = ss.sinkhorn_wmd_sparse(*args, FIG10["lam"], FIG10["n_iter"],
                                     **kw)
    want, want_it = ref_ss.sinkhorn_wmd_sparse(*ref_args, FIG10["lam"],
                                               FIG10["n_iter"], **kw)
    assert it == int(want_it) and it < FIG10["n_iter"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **R2)


def test_sparse_solver_doc_mask_scoping(dedup):
    """doc_mask narrows the exit: a one-doc scope exits no later than the
    full sweep, and the fastest one earlier, with the reference's counts;
    an empty scope exits at the first check (1 + check_every)."""
    ref_args, args = _sparse_args(dedup, 0)
    kw = dict(tol=PQ["tol"], check_every=PQ["check_every"],
              return_iters=True)
    lam, n_iter = PQ["lam"], PQ["n_iter"]
    full, it_full = ss.sinkhorn_wmd_sparse(*args, lam, n_iter, **kw)
    per_doc = []
    for j in range(8):
        dm = np.zeros(256, bool)
        dm[j] = True
        _, itj = ss.sinkhorn_wmd_sparse(*args, lam, n_iter, doc_mask=dm,
                                        **kw)
        _, ref_itj = ref_ss.sinkhorn_wmd_sparse(*ref_args, lam, n_iter,
                                                doc_mask=dm, **kw)
        assert itj == int(ref_itj) and itj <= it_full
        per_doc.append(itj)
    assert min(per_doc) < it_full
    near = int(np.argmin(per_doc))
    dm = np.zeros(256, bool)
    dm[near] = True
    scoped, _ = ss.sinkhorn_wmd_sparse(*args, lam, n_iter, doc_mask=dm, **kw)
    np.testing.assert_allclose(scoped.numpy()[near], full.numpy()[near],
                               rtol=2e-2, atol=1e-3)
    _, it_none = ss.sinkhorn_wmd_sparse(*args, lam, n_iter,
                                        doc_mask=np.zeros(256, bool), **kw)
    assert it_none == 3


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_kernel_path_adaptive_matches_sparse_and_reference(small_corpus,
                                                           precision):
    """ops.sinkhorn_wmd_kernel with tol and bf16: against the port's
    sparse solver with the same arguments (P3: the solver exits for all
    docs at once, the kernel per doc) and the reference's kernel path
    (P3 again, per block)."""
    ref_args, args = _sparse_args(small_corpus, 1)
    kw = dict(tol=3e-2, check_every=2, precision=precision)
    got = ops.sinkhorn_wmd_kernel(*args, 0.5, 15, **kw)
    sparse = ss.sinkhorn_wmd_sparse(*args, 0.5, 15, **kw)
    want = ref_ops.sinkhorn_wmd_kernel(*ref_args, 0.5, 15, interpret=True,
                                       **kw)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), sparse.numpy(), **P3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **P3)


# --------------------------------------------------------------- the engine
def test_iter_stats_reset(small_indexes, small_corpus):
    _, index = small_indexes
    eng = WmdEngine(index, lam=4.0, n_iter=7)
    eng.query_batch(list(small_corpus.queries[:2]))
    assert (eng.iter_stats() == 7).all() and eng.iter_stats().size > 0
    eng.reset_iter_stats()
    assert eng.iter_stats().size == 0 and eng.iter_stats_dropped == 0


def test_iter_stats_ring_counts_dropped(small_indexes, small_corpus):
    _, index = small_indexes
    eng = WmdEngine(index, lam=1.0, n_iter=5, iter_stats_maxlen=3)
    eng.query_batch(list(small_corpus.queries[:1]))   # 1 chunk x 4 groups
    assert len(index.groups) == 4 and eng.iter_stats_dropped == 1
    assert (eng.iter_stats() == 5).all() and eng.iter_stats().size == 3
    assert set(eng.iter_stats_by_stage()) == {"batch"}


def test_residual_padding_inert(small_indexes, small_corpus):
    """Pad docs (val 0) and filler queries (G 0, r 1) can neither stall
    the adaptive exit nor release it early: the real queries keep their
    counts and their distances (the reference test's 1e-6; on the card bit
    for bit); the pads stop at the first check."""
    _, index = small_indexes
    eng = WmdEngine(index, lam=4.0, n_iter=40, tol=1e-3, check_every=5)
    grp = index.groups[0]
    g, r, qc = _staged_g(eng, list(small_corpus.queries[:2]), grp)
    kw = dict(tol=1e-3, check_every=5, with_iters=True, block_n=8)
    wmd, it = ops.sinkhorn_fused_all_batched(g, grp.docs.val, r, 4.0, 40,
                                             **kw)
    q, v_r, n, length = g.shape
    g_p = torch.cat([torch.cat([g, torch.zeros(q, v_r, 8, length)], 2),
                     torch.zeros(2, v_r, n + 8, length)])
    val_p = torch.cat([grp.docs.val, torch.zeros(8, length)])
    r_p = torch.cat([r, torch.ones(2, v_r)])
    wmd_p, it_p = ops.sinkhorn_fused_all_batched(g_p, val_p, r_p, 4.0, 40,
                                                 **kw)
    nb = it.shape[1]
    assert torch.equal(it_p[:qc, :nb], it[:qc])
    np.testing.assert_allclose(wmd_p[:qc, :n].numpy(), wmd[:qc].numpy(),
                               rtol=1e-6, atol=1e-7)
    assert (it_p[:, nb:] == 6).all() and (it_p[q:] == 6).all()


@pytest.mark.parametrize("scope", ["query", "chunk"])
@pytest.mark.parametrize("call", ["query_batch", "search"])
@pytest.mark.parametrize("corpus,point", [("small", FIG10), ("dedup", FIG10),
                                          ("dedup", PQ)])
def test_iter_stats_match_reference_kernel_engine(
        small_indexes, dedup_indexes, small_corpus, dedup, corpus, point,
        call, scope):
    """The per-query realized counts equal the reference kernel engine's,
    stage by stage: a query's count is the largest of its docs', which is
    the reference's largest block count wherever residuals fall
    monotonically once below tol."""
    ref_index, index = (small_indexes if corpus == "small"
                        else dedup_indexes)
    qs = list((small_corpus if corpus == "small" else dedup).queries)
    lam, n_iter = point["lam"], point["n_iter"]
    kw = dict(tol=point["tol"], check_every=point["check_every"],
              scope=scope)
    eng = WmdEngine(index, lam=lam, n_iter=n_iter, **kw)
    ref_eng = RefEngine(ref_index, lam=lam, n_iter=n_iter, impl="kernel",
                        **kw)
    for e in (eng, ref_eng):
        if call == "query_batch":
            e.query_batch(qs)
        else:
            e.search(qs, 8, prune="rwmd")
    got, want = eng.iter_stats_by_stage(), ref_eng.iter_stats_by_stage()
    assert list(got) == list(want)
    for st in got:
        np.testing.assert_array_equal(got[st], want[st], err_msg=st)
    assert (got[list(got)[0]] < n_iter).any()


@pytest.mark.parametrize("corpus", ["small", "dedup"])
def test_engine_adaptive_distances_match_reference(
        small_indexes, dedup_indexes, small_corpus, dedup, corpus):
    """query_batch under fig10's tol against the reference kernel engine:
    within P3 (a converged doc of a block stops here, runs on there)."""
    ref_index, index = (small_indexes if corpus == "small"
                        else dedup_indexes)
    qs = list((small_corpus if corpus == "small" else dedup).queries)
    got = WmdEngine(index, **FIG10).query_batch(qs).numpy()
    want = np.asarray(RefEngine(ref_index, impl="kernel", **FIG10)
                      .query_batch(qs))
    np.testing.assert_allclose(got, want, **P3)


def test_p3_gap_is_the_exit_granularity(dedup_indexes, dedup):
    """The second witness for P3: the reference engine with block_n=1
    exits per document, as the port does, and the two then agree at P1's
    size (R2); at the default block_n=128 they differ by up to P3."""
    ref_index, index = dedup_indexes
    qs = list(dedup.queries)
    got = WmdEngine(index, **PQ).query_batch(qs).numpy()
    per_doc = np.asarray(RefEngine(ref_index, impl="kernel", block_n=1,
                                   **PQ).query_batch(qs))
    per_block = np.asarray(RefEngine(ref_index, impl="kernel", **PQ)
                           .query_batch(qs))
    np.testing.assert_allclose(got, per_doc, **R2)
    np.testing.assert_allclose(got, per_block, **P3)
    assert np.max(np.abs(got - per_block) / np.abs(per_block)) > 10 * R2[
        "rtol"]


def test_r7_log_domain_zero_padding_witness(small_indexes, small_corpus):
    """ROADMAP queue 3, R7: the reference's K1 wrapper pads the slot axis
    with 0, a valid log K, so in the log domain the bucket's pad query row
    (-inf elsewhere) gets exp(0 - 0) = 1 at the pad slots and counts as
    live in x0. Sinkhorn is scale-invariant, bf16 operand rounding is not.
    The port keeps pad rows inert: its K1 twin equals the reference's
    _solve_block on the tile as staged (6.2e-8) and padded with -inf, and
    differs from it padded with 0 (1.55e-4). The kernel impl's bf16+log
    engine is held to the reference's at R2 (5.3e-4); its realized counts
    are not compared."""
    from repro.kernels import sddmm_spmm as ref_sddmm
    ref_index, index = small_indexes
    eng = WmdEngine(index, lam=1.0, n_iter=15, precision="bf16+log")
    grp = index.groups[0]
    g, r, _ = _staged_g(eng, list(small_corpus.queries[:1]), grp)
    g, r, val = g[0], r[0], grp.docs.val
    assert not torch.isfinite(g[-1]).any()         # a bucket pad row
    port = ops.sinkhorn_fused_all(g, val, r, 1.0, 15, gemm="bf16",
                                  log_domain=True).numpy()

    def reference(pad, fill):
        gp = torch.nn.functional.pad(g, (0, pad), value=fill)
        vp = torch.nn.functional.pad(val, (0, pad))
        wmd, _ = ref_sddmm._solve_block(
            jnp.asarray(gp.numpy()), jnp.asarray(vp.numpy()),
            jnp.asarray(r.numpy())[:, None], 15, 1.0, gemm="bf16",
            log_domain=True)
        return np.abs(np.asarray(wmd) - port) / np.abs(port)

    pad = 128 - g.shape[2]                         # ops.py pads L to 128
    assert reference(0, 0.0).max() <= 1e-6
    assert reference(pad, -np.inf).max() <= 1e-6
    assert reference(pad, 0.0).max() > 1e-5
    qs = list(small_corpus.queries)
    got = eng.query_batch(qs).numpy()
    want = np.asarray(RefEngine(ref_index, lam=1.0, n_iter=15, impl="kernel",
                                precision="bf16+log").query_batch(qs))
    np.testing.assert_allclose(got, want, **R2)


def test_engine_kernel_impl_adaptive():
    """tol=0 at n_iter = 1 + 3*check_every runs to the cap and matches
    the reference's fixed sparse engine (the reference test's 5e-4)."""
    from repro.data.corpus import make_corpus as ref_make_corpus
    small = ref_make_corpus(vocab_size=256, embed_dim=16, n_docs=32,
                            n_queries=2, seed=4)
    ref_index = ref_build_index(small.docs, small.vecs)
    index = _carry(ref_index)
    ker = WmdEngine(index, lam=4.0, n_iter=13, tol=0.0, check_every=4)
    d_ref = np.asarray(RefEngine(ref_index, lam=4.0, n_iter=13)
                       .query_batch(list(small.queries)))
    d_ker = ker.query_batch(list(small.queries)).numpy()
    np.testing.assert_allclose(d_ker, d_ref, rtol=5e-4, atol=5e-4)
    assert (ker.iter_stats() == 13).all()


def test_bf16_within_tolerance_and_monotone(dedup_indexes, dedup):
    """bf16 within fig10's BF16_RTOL of fp32, ranked output monotone and
    within 5% of the fp32 top-k; against the reference's bf16 kernel
    engine at R2 (the operands round alike; P1 stays)."""
    ref_index, index = dedup_indexes
    queries = list(dedup.queries)
    fixed = WmdEngine(index, lam=0.25, n_iter=15)
    bf = WmdEngine(index, lam=0.25, n_iter=15, precision="bf16")
    d_f = fixed.query_batch(queries).numpy()
    d_b = bf.query_batch(queries).numpy()
    np.testing.assert_allclose(d_b, d_f, rtol=5e-2, atol=1e-3)
    want = np.asarray(RefEngine(ref_index, lam=0.25, n_iter=15,
                                impl="kernel", precision="bf16")
                      .query_batch(queries))
    np.testing.assert_allclose(d_b, want, **R2)
    k = 8
    res = bf.search(queries, k, prune="rwmd")
    for qi in range(len(queries)):
        row = res.distances[qi]
        assert (np.diff(row[~np.isnan(row)]) >= 0).all()
        kth = np.sort(d_f[qi])[k - 1]
        assert d_f[qi, res.indices[qi]].max() <= kth * 1.05 + 1e-3


@pytest.mark.parametrize("precision", ["log", "bf16+log"])
def test_log_domain_adaptive_engine_search(dedup_indexes, dedup, precision):
    """log (+ bf16) with the adaptive solve keeps the pruned-search
    contract: pruned top-k == its own exhaustive top-k."""
    _, index = dedup_indexes
    eng = WmdEngine(index, precision=precision, **FIG10)
    queries = list(dedup.queries)
    ex = eng.search(queries, 8, prune=None)
    pr = eng.search(queries, 8, prune="ivf+wcd+rwmd")
    for qi in range(len(queries)):
        assert set(ex.indices[qi]) == set(pr.indices[qi])


@pytest.mark.parametrize("prune", ["rwmd", "ivf+wcd+rwmd"])
@pytest.mark.parametrize("scope", ["query", "chunk"])
@pytest.mark.parametrize("point", ["fig10", "pq"])
def test_staged_equals_exhaustive_under_tol(dedup_indexes, dedup, prune,
                                            scope, point):
    """Under a per-doc exit a doc's distance does not depend on its launch
    mates, so staged top-10 equals exhaustive top-10 (ids, and distances
    at 1e-5) under tol. Under scope="query" a survivor outside its
    query's scope stops at the first check: its bound keeps it out."""
    _, index = dedup_indexes
    eng = WmdEngine(index, scope=scope, **(FIG10 if point == "fig10"
                                           else PQ))
    qs = list(dedup.queries)
    full = eng.query_batch(qs).numpy()
    res = eng.search(qs, 10, prune=prune)
    ex_i = np.argsort(full, axis=1, kind="stable")[:, :10]
    np.testing.assert_array_equal(res.indices, ex_i)
    np.testing.assert_allclose(res.distances,
                               np.take_along_axis(full, ex_i, 1),
                               rtol=1e-5, atol=0)


def test_per_query_exit_matches_chunk_topk(dedup_indexes, dedup):
    """Scoping the exit per query changes only what it costs: the same
    top-10 as scope="chunk", and a smaller per-query mean count."""
    _, index = dedup_indexes
    qs = list(dedup.queries)
    chunk = WmdEngine(index, scope="chunk", **PQ)
    query = WmdEngine(index, scope="query", **PQ)
    r_c = chunk.search(qs, 10, prune="rwmd")
    r_q = query.search(qs, 10, prune="rwmd")
    assert ([set(row) for row in r_c.indices.tolist()]
            == [set(row) for row in r_q.indices.tolist()])
    np.testing.assert_allclose(np.sort(r_q.distances, axis=1),
                               np.sort(r_c.distances, axis=1), rtol=2e-2,
                               atol=1e-3)
    it_c, it_q = chunk.iter_stats(), query.iter_stats()
    assert it_q.mean() < it_c.mean(), (it_c, it_q)
    assert it_q.max() <= it_c.max()


@pytest.mark.parametrize("mode", ["exact", "refine"])
def test_warm_start_is_inert_on_the_kernel_impl(dedup_indexes, dedup, mode):
    """warm_start=True equals False bit for bit on impl="kernel", with and
    without tol (the reference warm-starts only its einsum impl)."""
    _, index = dedup_indexes
    qs = list(dedup.queries)
    for kw in ({}, dict(tol=PQ["tol"], check_every=2)):
        a, b = (WmdEngine(index, lam=1.0, n_iter=30, warm_start=ws, **kw)
                .search(qs, 8, prune="ivf+wcd+rwmd", mode=mode)
                for ws in (False, True))
        np.testing.assert_array_equal(a.indices, b.indices)
        np.testing.assert_array_equal(a.distances, b.distances)


def test_engine_knobs_accepted_and_refused(small_indexes):
    _, index = small_indexes
    for kw in (dict(tol=1e-3), dict(scope="chunk"), dict(warm_start=True),
               dict(precision="bf16"), dict(precision="bf16+log"),
               dict(tol=1e-3, check_every=1, iter_stats_maxlen=2)):
        WmdEngine(index, **kw)
    WmdEngine(index, impl="sparse", kcache_slots=8)
    for kw in (dict(impl="dense"), dict(kcache_slots=8)):
        with pytest.raises(ValueError):
            WmdEngine(index, **kw)
    with pytest.raises(ValueError, match="check_every"):
        WmdEngine(index, tol=1e-3, check_every=0)


def test_serve_cli_adaptive_bf16_record():
    """The serve CLI's adaptive flags on a tiny corpus, on the host: the
    record carries the realized counts."""
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--wmd",
         "--device", "cpu", "--n-docs", "48", "--vocab", "256",
         "--embed-dim", "16", "--steps", "2", "--batch-queries", "2",
         "--lam", "0.25", "--tol", "0.03", "--check-every", "2",
         "--precision", "bf16", "--top-k", "4"],
        capture_output=True, text=True, timeout=300, cwd=root,
        env={**os.environ, "PYTHONPATH": str(root / "src")})
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["precision"] == "bf16" and rec["tol"] == 0.03
    assert rec["scope"] == "query" and rec["iter_stats_dropped"] == 0
    assert 1 <= rec["solve_iters_mean"] <= rec["solve_iters_max"] <= 16
    assert (rec["solve_iters_max"] - 1) % 2 == 0
    assert "solve_iters_seed_mean" in rec


def test_make_corpus_engine_bf16_log_runs_at_large_lam():
    """bf16+log at lam far past the fp32 exp horizon completes, adaptive."""
    c = make_corpus(vocab_size=256, embed_dim=16, n_docs=32, n_queries=2,
                    seed=4)
    eng = WmdEngine(build_index(c.docs, c.vecs, device="cpu"), lam=80.0,
                    n_iter=9, tol=1e-2, check_every=4,
                    precision="bf16+log")
    d = eng.query_batch(list(c.queries)).numpy()
    assert np.isfinite(d).all()
    assert ((eng.iter_stats() - 1) % 4 == 0).all()


def test_bf16_gap_grows_with_width():
    """R6 (ROADMAP queue 3): fig10's BF16_RTOL=5e-2 was set at w=64. At
    the paper's w=300 the bf16 operands of the K block's w-long product
    move M by more, and the reference's own bf16 engine differs from fp32
    by more than 5e-2 (7.4% measured); the port's bf16 engine follows the
    reference's (R2) and fp32 at the same size."""
    c = ref_dedup_corpus(256, vocab=2048, embed_dim=300, seed=5)
    ref_index = ref_build_index(c.docs, c.vecs)
    index = _carry(ref_index)
    qs = list(c.queries)
    kw = dict(lam=0.25, n_iter=15)
    ref32 = np.asarray(RefEngine(ref_index, impl="kernel", **kw)
                       .query_batch(qs))
    ref16 = np.asarray(RefEngine(ref_index, impl="kernel", precision="bf16",
                                 **kw).query_batch(qs))
    got16 = WmdEngine(index, precision="bf16", **kw).query_batch(qs).numpy()
    got32 = WmdEngine(index, **kw).query_batch(qs).numpy()

    def gap(a, b):
        return float(np.max(np.abs(a - b) / np.abs(b)))

    assert gap(ref16, ref32) > 5e-2 and gap(got16, got32) > 5e-2
    assert gap(got16, got32) < 1e-1
    np.testing.assert_allclose(got16, ref16, **R2)
