"""The port's kernel wrappers on the CPU (their plain versions) against
the reference's Pallas kernels in interpret mode. The Hopper kernels
themselves are held against the plain versions in test_torch_gpu.py."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import sinkhorn_sparse as ref_ss
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro_torch.core import sinkhorn_sparse
from repro_torch.kernels import ops, ref

# as tests/test_kernels.py holds the reference kernels to their oracles
K1_TOL = dict(rtol=5e-5, atol=5e-5)
K2_TOL = dict(rtol=1e-5, atol=1e-5)
K3_TOL = dict(rtol=2e-3, atol=5e-3)
K4_TOL = K1_TOL
K5_TOL = dict(rtol=1e-5, atol=1e-5)


def _k2_inputs(rng, q=3, b=10, w=16, v=200):
    a = rng.standard_normal((q, b, w)).astype(np.float32)
    mask = (rng.random((q, b)) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    mask[q - 1] = 0.0                     # an all-masked (filler) row
    vocab = rng.standard_normal((v, w)).astype(np.float32)
    return a, mask, vocab


def test_rwmd_min_cdist_plain_matches_reference(rng):
    a, mask, b = _k2_inputs(rng)
    got = ops.rwmd_min_cdist(*map(torch.from_numpy, (a, mask, b))).numpy()
    pallas = np.asarray(ref_ops.rwmd_min_cdist(
        jnp.asarray(a), jnp.asarray(mask), jnp.asarray(b), interpret=True))
    oracle = np.asarray(ref_ref.rwmd_min_cdist_ref(
        jnp.asarray(a), jnp.asarray(mask), jnp.asarray(b)))
    assert np.isinf(got[-1]).all() and np.isinf(pallas[-1]).all()
    np.testing.assert_allclose(got, pallas, **K2_TOL)
    np.testing.assert_allclose(got, oracle, **K2_TOL)


@pytest.mark.parametrize("b_rows,w,n_ids,edge", [
    (12, 40, 70, None), (200, 40, 70, None), (24, 40, 45, "repeats"),
    (24, 61, 70, "dead_query"), (130, 40, 33, "dead_query")],
    ids=["12", "200", "vc_ragged_repeats", "w61_dead_query",
         "b130_dead_query"])
def test_rwmd_min_cdist_subset_plain_matches_pallas(rng, b_rows, w, n_ids,
                                                    edge):
    """K2s's plain version (and the wrapper's vocab_ids path on the CPU)
    against the Pallas rwmd_min_cdist_subset in interpret mode, at
    tests/test_ivf.py's shapes and tolerance, on the card kernel's edges:
    a Vc that is no multiple of its 32-column tile, repeated ids (the
    cascade pads its tail with the first id), a query with every row
    masked (+inf), more than 128 support rows (passes of 128 rows on the
    card), and w = 61 (no multiple of 4: the card's 4-byte copies)."""
    a = rng.standard_normal((3, b_rows, w)).astype(np.float32)
    b = rng.standard_normal((300, w)).astype(np.float32)
    mask = (rng.random((3, b_rows)) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    vids = np.unique(rng.integers(0, 300, n_ids)).astype(np.int32)
    if edge == "repeats":
        vids[-len(vids) // 4:] = vids[0]
    if edge == "dead_query":
        mask[1] = 0.0
    ta, tm, tb = map(torch.from_numpy, (a, mask, b))
    tv = torch.from_numpy(vids.astype(np.int64))
    got = ops.rwmd_min_cdist(ta, tm, tb, vocab_ids=tv).numpy()
    plain = ref.rwmd_min_cdist_subset_ref(ta, tm, tb, tv).numpy()
    pallas = np.asarray(ref_ops.rwmd_min_cdist(
        jnp.asarray(a), jnp.asarray(mask), jnp.asarray(b), block_v=128,
        interpret=True, vocab_ids=jnp.asarray(vids)))
    assert got.shape == pallas.shape == (3, vids.size)
    if edge == "dead_query":
        assert np.isinf(got[1]).all() and np.isinf(pallas[1]).all()
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_allclose(got, pallas, rtol=1e-4, atol=1e-4)
    full = ops.rwmd_min_cdist(ta, tm, tb).numpy()
    np.testing.assert_allclose(got, full[:, vids], rtol=1e-6, atol=1e-6)


def test_rwmd_min_cdist_subset_validates_ids(rng):
    a, mask, b = map(torch.from_numpy, _k2_inputs(rng))
    with pytest.raises(TypeError, match="int64"):
        ops.rwmd_min_cdist(a, mask, b,
                           vocab_ids=torch.arange(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="1-D"):
        ops.rwmd_min_cdist(a, mask, b, vocab_ids=torch.zeros(
            (2, 2), dtype=torch.int64))
    for bad in (-1, b.shape[0]):
        with pytest.raises(ValueError, match="vocab_ids must lie in"):
            ops.rwmd_min_cdist(a, mask, b, vocab_ids=torch.tensor(
                [0, bad], dtype=torch.int64))


def _k1_inputs(rng, log_domain, q=2, v_r=8, n=256, length=8, lam=3.0):
    """G as the solver sees it: gathered K = exp(-lam*M), or log K; pad
    query rows (G 0 / -inf, r 1) and pad docs (val 0)."""
    m = rng.uniform(0.1, 1.5, (q, v_r, n, length)).astype(np.float32)
    g = (-lam * m) if log_domain else np.exp(-lam * m)
    g = g.astype(np.float32)
    live_rows = [v_r, v_r - 3]
    r = np.ones((q, v_r), np.float32)
    for qi, nr in enumerate(live_rows):
        g[qi, nr:] = -np.inf if log_domain else 0.0
        w = rng.uniform(0.1, 1.0, nr)
        r[qi, :nr] = w / w.sum()
    val = np.where(rng.random((n, length)) > 0.4,
                   rng.random((n, length)), 0.0)
    val[:, 0] = np.maximum(val[:, 0], 0.05)   # every real doc has a word
    val[n - 20:] = 0.0                        # pad docs
    val = (val / np.maximum(val.sum(1, keepdims=True), 1e-9))
    return g, val.astype(np.float32), r, lam


@pytest.mark.parametrize("log_domain", [False, True])
def test_sinkhorn_fused_plain_matches_pallas(rng, log_domain):
    g, val, r, lam = _k1_inputs(rng, log_domain)
    n_iter = 10
    got, iters = ops.sinkhorn_fused_all_batched(
        *map(torch.from_numpy, (g, val, r)), lam, n_iter,
        log_domain=log_domain, with_iters=True)
    want, want_iters = ref_ops.sinkhorn_fused_all_batched(
        jnp.asarray(g), jnp.asarray(val), jnp.asarray(r), lam, n_iter,
        log_domain=log_domain, interpret=True, with_iters=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **K1_TOL)
    np.testing.assert_array_equal(iters.numpy(), np.asarray(want_iters))
    assert np.all(got.numpy()[:, -20:] == 0.0)        # pad docs are inert


@pytest.mark.parametrize("log_domain", [False, True])
@pytest.mark.parametrize("opts", [
    dict(), dict(tol=1e-2, check_every=2), dict(tol=1e-2, check_every=3,
                                                resmask=True),
    dict(tol=-1.0, check_every=4), dict(tol=1e-2, check_every=8)],
    ids=["fixed", "adaptive", "resmask", "tol_below_0", "check_past_cap"])
def test_inert_docs_give_zero_and_the_schedule_count(rng, log_domain, opts):
    """The contract K1 keeps when it skips an inert doc's solve (one whose
    val row has no entry > 0): the plain version gives such a doc
    distance 0 and the count :func:`ref.inert_doc_iters` names, and a
    block of block_n docs that mixes live and inert docs keeps its largest
    count."""
    g, val, r, lam = _k1_inputs(rng, log_domain)
    n_iter, block_n = 7, 16
    n = val.shape[0]
    inert = np.zeros(n, bool)
    inert[3::3] = True                        # live and inert in every block
    inert[n - 20:] = True                     # the pad docs
    val[inert] = 0.0
    kw = dict(opts)
    if kw.pop("resmask", False):
        rm = (rng.random((g.shape[0], n)) > 0.5).astype(np.float32)
        kw["resmask"] = torch.from_numpy(rm)
    g, val, r = map(torch.from_numpy, (g, val, r))
    wmd, counts, _ = ref.solve_per_doc_ref(g, val, r, lam, n_iter,
                                           log_domain=log_domain, **kw)
    want = ref.inert_doc_iters(n_iter, kw.get("tol"),
                               kw.get("check_every", 4))
    assert (wmd[:, inert] == 0.0).all()
    assert (counts[:, inert] == want).all()
    assert torch.isfinite(wmd[:, ~inert]).all() and (wmd[:, ~inert] > 0).all()
    _, iters = ops.sinkhorn_fused_all_batched(g, val, r, lam, n_iter,
                                              block_n=block_n,
                                              with_iters=True,
                                              log_domain=log_domain, **kw)
    torch.testing.assert_close(iters, ref.block_iters(counts, block_n))
    assert (iters[:, -1] == want).all()       # the last block is all inert


def test_sinkhorn_fused_linear_underflow_is_nan():
    """A live doc word whose K column underflowed to all zero poisons the
    doc's distance (the engine raises LamUnderflowError on it)."""
    g = np.full((1, 2, 2, 2), 0.5, np.float32)
    g[0, :, 1, 0] = 0.0                       # doc 1, slot 0: dead column
    val = np.full((2, 2), 0.5, np.float32)
    r = np.full((1, 2), 0.5, np.float32)
    wmd = ops.sinkhorn_fused_all_batched(
        *map(torch.from_numpy, (g, val, r)), 1.0, 3).numpy()
    assert np.isfinite(wmd[0, 0]) and np.isnan(wmd[0, 1])
    with np.errstate(divide="ignore"):
        log_g = np.log(g)                     # the dead column is -inf
    logd = ops.sinkhorn_fused_all_batched(
        *map(torch.from_numpy, (log_g, val, r)), 1.0, 3,
        log_domain=True).numpy()
    assert np.isfinite(logd).all()


def test_reconstruct_gm_matches_reference(rng):
    g = rng.uniform(0.0, 1.0, (4, 6, 5)).astype(np.float32)
    g[0, 0] = 0.0
    got = ref.reconstruct_gm_ref(torch.from_numpy(g), 2.5).numpy()
    np.testing.assert_allclose(
        got, np.asarray(ref_ref.reconstruct_gm_ref(jnp.asarray(g), 2.5)),
        rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        sinkhorn_sparse.reconstruct_gm(torch.from_numpy(g), 2.5).numpy(),
        np.asarray(ref_ss.reconstruct_gm(jnp.asarray(g), 2.5)),
        rtol=1e-6, atol=1e-7)
    shift = rng.standard_normal((3, 5)).astype(np.float32)
    val = rng.random((3, 5)).astype(np.float32)
    np.testing.assert_allclose(
        sinkhorn_sparse.log_shift_correction(
            torch.from_numpy(shift), torch.from_numpy(val), 4.0).numpy(),
        np.asarray(ref_ss.log_shift_correction(jnp.asarray(shift),
                                               jnp.asarray(val), 4.0)),
        rtol=1e-6)


def test_cdist_support_and_underflow_report_match_reference(rng):
    from repro.core import sinkhorn as ref_sk
    from repro_torch.core import sinkhorn as sk
    a = rng.standard_normal((7, 12)).astype(np.float32)
    b = rng.standard_normal((40, 12)).astype(np.float32)
    np.testing.assert_allclose(
        sk.cdist(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(ref_sk.cdist(jnp.asarray(a), jnp.asarray(b))),
        rtol=1e-5, atol=1e-5)
    q = np.where(rng.random(40) > 0.7, rng.random(40), 0.0)
    got = sk.select_support(q, b)
    want = ref_sk.select_support(q, b)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-6)
    docs = (np.array([[0, 3], [5, 0]], np.int32),
            np.array([[0.5, 0.5], [1.0, 0.0]], np.float32))
    from repro.core.sparse import PaddedDocs as RefDocs
    from repro_torch.core.sparse import PaddedDocs
    assert sk.MAX_NEG_EXP == ref_sk.MAX_NEG_EXP
    msg = sk.underflow_report(40.0, got[1], b, PaddedDocs(*docs))
    ref_msg = ref_sk.underflow_report(40.0, want[1], b, RefDocs(*docs))
    # the same diagnosis; only the advice's list of escape hatches differs
    assert msg.split(" The Sinkhorn")[0] == ref_msg.split(" The Sinkhorn")[0]


def test_solve_precision_parse_matches_reference():
    for spec in (None, "fp32", "log", "bf16", "bf16+log", "log+fp32"):
        got = sinkhorn_sparse.SolvePrecision.parse(spec)
        want = ref_ss.SolvePrecision.parse(spec)
        assert (got.gemm, got.log_domain, got.name) == \
            (want.gemm, want.log_domain, want.name)
    with pytest.raises(ValueError):
        sinkhorn_sparse.SolvePrecision.parse("fp16")


def test_cpu_tensors_leave_launch_counts_at_zero(rng):
    ops.reset_launches()
    a, mask, b = _k2_inputs(rng)
    ops.rwmd_min_cdist(*map(torch.from_numpy, (a, mask, b)))
    g, val, r, lam = _k1_inputs(rng, False, n=16)
    ops.sinkhorn_fused_all_batched(*map(torch.from_numpy, (g, val, r)),
                                   lam, 2)
    gt, vt, rt = map(torch.from_numpy, (g[0], val, r[0]))
    ops.cdist_exp(torch.from_numpy(a[0]), torch.from_numpy(b),
                  torch.ones(a.shape[1]), lam)
    ops.sinkhorn_fused_all(gt, vt, rt, lam, 2)
    ops.sddmm_spmm_step(gt, gt, vt, torch.ones(gt.shape[:2]))
    ops.rwmd_min_cdist(*map(torch.from_numpy, (a, mask, b)),
                       vocab_ids=torch.arange(5))
    from repro_torch.core.sparse import block_sparse_from_dense
    cb = block_sparse_from_dense(torch.eye(64), 32, 32)
    ops.bsr_sddmm(torch.ones((64, 3)), torch.ones((3, 64)), cb)
    assert ops.launches() == {"rwmd_min_cdist": 0,
                              "sinkhorn_fused_all_batched": 0,
                              "cdist_exp": 0, "sinkhorn_fused_all": 0,
                              "sddmm_spmm_step": 0,
                              "rwmd_min_cdist_subset": 0,
                              "bsr_sddmm_blocks": 0}


@pytest.mark.parametrize("kwargs", [dict(tol=1e-3), dict(resmask=True),
                                    dict(gemm="bf16")])
def test_unported_solver_options_raise(rng, kwargs):
    """The solver options run; what the kernels do not take raises: a
    check period below 1 with tol, a resmask of the wrong shape, an
    operand type other than fp32 and bf16."""
    g, val, r, lam = _k1_inputs(rng, False, n=16)
    gt, vt, rt = map(torch.from_numpy, (g, val, r))
    if "resmask" in kwargs:
        kwargs = dict(tol=1e-3, resmask=torch.ones((g.shape[0], g.shape[2])))
        bad = dict(tol=1e-3, resmask=torch.ones((g.shape[0], 3)))
    elif "tol" in kwargs:
        bad = dict(tol=1e-3, check_every=0)
    else:
        bad = dict(gemm="fp16")
    out = ops.sinkhorn_fused_all_batched(gt, vt, rt, lam, 2, **kwargs)
    assert torch.isfinite(out[:, :-20]).all()
    with pytest.raises(ValueError):
        ops.sinkhorn_fused_all_batched(gt, vt, rt, lam, 2, **bad)


def test_wrappers_validate_inputs(rng):
    a, mask, b = map(torch.from_numpy, _k2_inputs(rng))
    with pytest.raises(TypeError):
        ops.rwmd_min_cdist(a.double(), mask, b)
    with pytest.raises(ValueError):
        ops.rwmd_min_cdist(a, mask[:, :3], b)
    with pytest.raises(ValueError):
        ops.rwmd_min_cdist(a.transpose(1, 2).contiguous().transpose(1, 2),
                           mask, b)
    g, val, r, lam = _k1_inputs(rng, False, n=16)
    with pytest.raises(ValueError):
        ops.sinkhorn_fused_all_batched(torch.from_numpy(g),
                                       torch.from_numpy(val[:, :3]),
                                       torch.from_numpy(r), lam, 2)
    gt, vt, rt = map(torch.from_numpy, (g, val, r))
    with pytest.raises(ValueError, match="tile must be one of"):
        ops.sinkhorn_fused_all_batched(gt, vt, rt, lam, 2, tile="texture")
    # "global" (G read from device memory) is a variant since the tile
    # over the shared-memory limit runs; on the host it is the plain version
    torch.testing.assert_close(
        ops.sinkhorn_fused_all_batched(gt, vt, rt, lam, 2, tile="global"),
        ops.sinkhorn_fused_all_batched(gt, vt, rt, lam, 2))
    wide = torch.zeros((1, 65, 16, val.shape[1]), dtype=torch.float32)
    with pytest.raises(ValueError, match="at most 64 x 64"):
        ops.sinkhorn_fused_all_batched(wide, vt, torch.ones((1, 65)), lam, 2,
                                       tile="registers")


@pytest.mark.parametrize("tile", ["warp", "registers", "shared"])
def test_k1_tiles_compute_one_function_on_the_host(rng, tile):
    """Every K1 tile is the same function: on the host each is the plain
    version; "warp" holds 64 x 64 at most, as "registers" does."""
    g, val, r, lam = _k1_inputs(rng, True, n=24)
    gt, vt, rt = map(torch.from_numpy, (g, val, r))
    torch.testing.assert_close(
        ops.sinkhorn_fused_all_batched(gt, vt, rt, lam, 3, tile=tile,
                                       log_domain=True),
        ops.sinkhorn_fused_all_batched(gt, vt, rt, lam, 3, log_domain=True))
    if tile != "shared":
        wide = torch.zeros((1, 8, 4, 65), dtype=torch.float32)
        with pytest.raises(ValueError, match="at most 64 x 64"):
            ops.sinkhorn_fused_all_batched(wide, torch.ones((4, 65)),
                                           torch.ones((1, 8)), lam, 2,
                                           tile=tile)


def test_k2_designs_are_checked(rng):
    """K2 has one design, the stacked-query kernel, at any number of
    queries (one launch on the card, a block per RWMD_STACKED_MAX_Q of
    them): more queries than one block holds equal the plain version query
    by query,
    and the removed ``design`` keyword raises TypeError."""
    a, mask, b = map(torch.from_numpy, _k2_inputs(rng))
    with pytest.raises(TypeError):
        ops.rwmd_min_cdist(a, mask, b, design="stacked")
    q = ops.RWMD_STACKED_MAX_Q + 1
    many = torch.from_numpy(rng.standard_normal((q, 3, a.shape[2])).astype(
        np.float32))
    live = torch.from_numpy((rng.random((q, 3)) > 0.3).astype(np.float32))
    live[:, 0] = 1.0
    got = ops.rwmd_min_cdist(many, live, b)
    assert got.shape == (q, b.shape[0])
    for qi in range(q):
        torch.testing.assert_close(
            got[qi], ref.rwmd_min_cdist_ref(many[qi:qi + 1],
                                            live[qi:qi + 1], b)[0])


# ----------------------------------------------------------- K3 cdist_exp
def _t(*arrays):
    return tuple(torch.from_numpy(np.array(x)) for x in arrays)


@pytest.mark.parametrize("v_r,v,w", [(8, 256, 128), (19, 512, 300),
                                     (43, 384, 64), (5, 128, 32),
                                     (64, 1024, 256), (23, 200, 61),
                                     (70, 300, 300)])
@pytest.mark.parametrize("mode", ["full", "k_only", "log_k"])
def test_cdist_exp_plain_matches_pallas(rng, v_r, v, w, mode):
    """tests/test_kernels.py's shapes and tolerances, in the three modes
    (lam=5; log_k emits -lam*M, so its tolerance scales by lam), and the
    card kernel's edges: w = 61 (no multiple of 4: its 4-byte copies) with
    V = 200 (no multiple of its 128-row vocabulary tile), and v_r = 70
    (two row tiles of 64)."""
    a = rng.standard_normal((v_r, w)).astype(np.float32)
    b = rng.standard_normal((v, w)).astype(np.float32)
    r = rng.uniform(0.01, 1.0, v_r).astype(np.float32)
    lam, k_only, log_k = 5.0, mode != "full", mode == "log_k"
    got = ops.cdist_exp(*_t(a, b, r), lam, k_only=k_only, log_k=log_k)
    want = ref_ops.cdist_exp(jnp.asarray(a), jnp.asarray(b), jnp.asarray(r),
                             lam, interpret=True, k_only=k_only, log_k=log_k)
    if k_only:
        tol = dict(rtol=2e-3, atol=lam * 5e-3) if log_k else K3_TOL
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
        return
    for g, wnt, tol in zip(got, want, (K3_TOL, K3_TOL,
                                       dict(rtol=2e-3, atol=5e-2))):
        assert g.shape == (v_r, v)
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), **tol)


def test_cdist_exp_k_only_matches_full(rng):
    a, b = rng.standard_normal((16, 128)), rng.standard_normal((256, 128))
    a, b, r = _t(a.astype(np.float32), b.astype(np.float32),
                 rng.uniform(0.1, 1.0, 16).astype(np.float32))
    _, k_full, _ = ops.cdist_exp(a, b, r, 4.0)
    assert torch.equal(ops.cdist_exp(a, b, r, 4.0, k_only=True), k_full)


# ------------------------------------------- K4 sinkhorn_fused_all
def _k4_inputs(rng, v_r, n, length, log_domain, lam=7.0):
    g = rng.uniform(0.02, 1.0, (v_r, n, length)).astype(np.float32)
    if log_domain:
        g = np.log(g)                        # log K, as K3's log_k gives
    val = np.abs(rng.standard_normal((n, length)))
    val = np.where(val > 0.5, val, 0.0)
    val[:, 0] = 1.0                          # every doc has >= 1 word
    r = rng.uniform(0.1, 1.0, v_r).astype(np.float32)
    return g, val.astype(np.float32), r, lam


@pytest.mark.parametrize("log_domain", [False, True])
@pytest.mark.parametrize("v_r,n,length,n_iter,block_n", [
    (19, 128, 40, 15, 64), (8, 64, 16, 5, 32), (43, 256, 64, 25, 128)])
def test_sinkhorn_fused_all_plain_matches_pallas(rng, log_domain, v_r, n,
                                                 length, n_iter, block_n):
    g, val, r, lam = _k4_inputs(rng, v_r, n, length, log_domain)
    got, iters = ops.sinkhorn_fused_all(*_t(g, val, r), lam, n_iter,
                                        block_n=block_n,
                                        log_domain=log_domain,
                                        with_iters=True)
    want, want_iters = ref_ops.sinkhorn_fused_all(
        jnp.asarray(g), jnp.asarray(val), jnp.asarray(r), lam, n_iter,
        block_n=block_n, log_domain=log_domain, interpret=True,
        with_iters=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **K4_TOL)
    np.testing.assert_array_equal(iters.numpy(), np.asarray(want_iters))


@pytest.mark.parametrize("log_domain", [False, True])
def test_sinkhorn_fused_all_padded_rows_and_docs_are_inert(rng,
                                                           log_domain):
    """The reference's test_fused_all_handles_padded_rows, plus all-pad
    docs (val == 0), against the Pallas kernel on the same padded input."""
    v_r, n, length = 10, 64, 16
    g, val, r, lam = _k4_inputs(rng, v_r, n, length, log_domain, lam=5.0)
    val[-8:] = 0.0                                    # all-pad docs
    base = ops.sinkhorn_fused_all(*_t(g, val, r), lam, 10,
                                  log_domain=log_domain)
    pad = np.full((6, n, length), -np.inf if log_domain else 0.0,
                  np.float32)
    g2 = np.concatenate([g, pad])
    r2 = np.concatenate([r, np.ones(6, np.float32)])
    padded = ops.sinkhorn_fused_all(*_t(g2, val, r2), lam, 10,
                                    log_domain=log_domain)
    np.testing.assert_allclose(padded.numpy(), base.numpy(), rtol=1e-6,
                               atol=1e-6)
    assert np.all(padded.numpy()[-8:] == 0.0)
    want = ref_ops.sinkhorn_fused_all(
        jnp.asarray(g2), jnp.asarray(val), jnp.asarray(r2), lam, 10,
        log_domain=log_domain, interpret=True)
    np.testing.assert_allclose(padded.numpy(), np.asarray(want), **K4_TOL)


# ------------------------------------------------- K5 sddmm_spmm_step
# the slot whose G column is subnormal (edges "subnormal", dead, and
# "subnormal_live", live): t ~ 1e-41, below the smallest normal fp32, so
# K5's guard gives 1/t = 0 and w = 0 there, as the reference's flushed fp32
# does (unguarded, 1/t overflows to inf: 0 * inf = NaN at the dead slot)
K5_SUBNORMAL_DOC, K5_SUBNORMAL_SLOT = 1, 9


def _k5_inputs(rng, v_r, n, length, edge):
    """K5's inputs on the card kernel's edges. "last_live": each doc's
    live slots end at a slot drawn from 0 (all-pad) to L, with dead slots
    inside; "x_zero": whole rows and columns of x are 0 (u = 0);
    "subnormal": "last_live", and one dead slot past a doc's last live
    one has a subnormal G column; "subnormal_live": that slot is live
    (val > 0); "gr_inf": "last_live", and one G/r entry at doc 2's dead
    last slot is inf (inf * w = inf * 0 = NaN)."""
    g = np.abs(rng.standard_normal((v_r, n, length))).astype(np.float32)
    g += 0.1
    gor = g * 1.7
    val = np.abs(rng.standard_normal((n, length))).astype(np.float32)
    val = np.where(val > 0.8, val, 0.0).astype(np.float32)
    x = (np.abs(rng.standard_normal((v_r, n))) + 0.5).astype(np.float32)
    x[0, :4] = 0.0                                    # guarded 1/x
    if edge in ("last_live", "subnormal", "subnormal_live", "gr_inf"):
        ends = rng.integers(0, length + 1, n)
        ends[:3] = (0, length, 1)
        for d, e in enumerate(ends):
            val[d, e:] = 0.0
            if e:
                val[d, e - 1] = 1.0 + rng.random()
    if edge == "x_zero":
        x[v_r // 2] = 0.0
        x[:, n // 2] = 0.0
        x[rng.random((v_r, n)) < 0.1] = 0.0
    if edge == "subnormal":
        val[K5_SUBNORMAL_DOC, K5_SUBNORMAL_SLOT - 4:] = 0.0
        g[:, K5_SUBNORMAL_DOC, K5_SUBNORMAL_SLOT] = 1e-42
    if edge == "subnormal_live":
        val[K5_SUBNORMAL_DOC, K5_SUBNORMAL_SLOT] = 1.5
        g[:, K5_SUBNORMAL_DOC, K5_SUBNORMAL_SLOT] = 1e-42
    if edge == "gr_inf":
        val[2, length - 1] = 0.0
        gor[3, 2, length - 1] = np.inf
    return g, gor, val, x


@pytest.mark.parametrize("v_r,n,length,edge", [
    pytest.param(8, 128, 128, None, id="8-128-128"),
    pytest.param(19, 64, 40, None, id="19-64-40"),
    pytest.param(32, 256, 64, None, id="32-256-64"),
    pytest.param(3, 32, 8, None, id="3-32-8"),
    pytest.param(19, 96, 28, "last_live", id="last_live"),
    pytest.param(23, 96, 30, "last_live", id="last_live_l30"),
    pytest.param(5, 48, 13, "last_live", id="last_live_l13"),
    pytest.param(40, 64, 28, "last_live", id="vr40"),
    pytest.param(70, 64, 36, "last_live", id="vr70_l36"),
    pytest.param(23, 64, 28, "x_zero", id="x_zero"),
    pytest.param(23, 64, 28, "subnormal", id="subnormal"),
    pytest.param(23, 64, 28, "subnormal_live", id="subnormal_live"),
    pytest.param(23, 64, 28, "gr_inf", id="gr_inf")])
def test_sddmm_spmm_step_plain_matches_pallas(rng, v_r, n, length, edge):
    """K5's plain version against the Pallas kernel in interpret mode, on
    the edges of the card kernel's design: the last live slot anywhere
    from 0 to L, L no multiple of 4 or over 32 (slot classes), v_r over
    32 and over 64 (row chunks of 32), zero x, an inf G/r entry at a
    dead slot (NaN in both, at that entry alone), and a subnormal G
    column at a dead and at a live slot: XLA on the CPU flushes the
    subnormal products to 0, and the plain version's guard takes a
    subnormal t as not positive, so both give w = 0 there and no NaN, on
    the same unflushed inputs."""
    g, gor, val, x = _k5_inputs(rng, v_r, n, length, edge)
    got = ops.sddmm_spmm_step(*_t(g, gor, val, x)).numpy()
    want = np.asarray(ref_ops.sddmm_spmm_step(
        *map(jnp.asarray, (g, gor, val, x)), block_n=32, interpret=True))
    if edge in ("subnormal", "subnormal_live"):
        assert not np.isnan(got).any() and not np.isnan(want).any()
        # w = 0 at the subnormal column: x' as with that slot dead and G 0
        flushed = (g.copy(), val.copy())
        flushed[0][:, K5_SUBNORMAL_DOC, K5_SUBNORMAL_SLOT] = 0.0
        flushed[1][K5_SUBNORMAL_DOC, K5_SUBNORMAL_SLOT] = 0.0
        np.testing.assert_array_equal(got, ops.sddmm_spmm_step(
            *_t(flushed[0], gor, flushed[1], x)).numpy())
    if edge == "gr_inf":
        nan = np.zeros_like(got, dtype=bool)
        nan[3, 2] = True
        np.testing.assert_array_equal(np.isnan(want), nan)
        np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_allclose(got, want, **K5_TOL)


@pytest.mark.parametrize("edge", ["subnormal", "subnormal_live"])
def test_chip_smoke_k5_subnormal_inputs_are_this_files(edge):
    """chip_smoke.py holds the card's K5 against its plain version at the
    inputs of the subnormal cases above, drawn from their seeds."""
    import sys
    import zlib
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    rng = np.random.default_rng(zlib.adler32(
        "tests/test_torch_kernels.py::test_sddmm_spmm_step_plain_matches_"
        f"pallas[{edge}]".encode()))
    want = _k5_inputs(rng, *chip_smoke.K5_SUBNORMAL_SHAPE, edge)
    got = chip_smoke.k5_subnormal_inputs(edge)
    assert (chip_smoke.K5_SUBNORMAL_DOC, chip_smoke.K5_SUBNORMAL_SLOT) == (
        K5_SUBNORMAL_DOC, K5_SUBNORMAL_SLOT)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------ the kernel path (K3 -> K4)
@pytest.mark.parametrize("precision,lam", [("fp32", 2.0), ("log", 10.0)])
def test_sinkhorn_wmd_kernel_matches_reference(small_corpus, precision,
                                               lam):
    """At lam=10 the linear path underflows on this corpus; the log
    domain runs. P1 (ROADMAP queue 3) bounds the gap: ~2e-5 measured."""
    from repro.core.sinkhorn import select_support as ref_select
    from repro_torch.core.sparse import PaddedDocs
    r, sel, _ = ref_select(small_corpus.queries[0], small_corpus.vecs)
    docs = PaddedDocs(*_t(small_corpus.docs.idx, small_corpus.docs.val))
    got = ops.sinkhorn_wmd_kernel(*_t(r, sel, small_corpus.vecs),
                                  PaddedDocs(docs.idx.long(), docs.val),
                                  lam, 15, precision=precision)
    want = ref_ops.sinkhorn_wmd_kernel(r, sel, jnp.asarray(small_corpus.vecs),
                                       small_corpus.docs, lam, 15,
                                       interpret=True, precision=precision)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("call", ["cdist_exp", "sinkhorn_fused_all",
                                  "sinkhorn_wmd_kernel"])
def test_unported_one_query_options_raise(rng, call):
    """bf16 and tol run on the one-query path; an operand type other than
    fp32 and bf16, or a check period below 1, raises."""
    g, val, r, lam = _k4_inputs(rng, 4, 8, 3, False)
    gt, vt, rt = _t(g, val, r)
    a = rt[:, None].contiguous()
    if call == "cdist_exp":
        assert torch.isfinite(ops.cdist_exp(a, a, rt, lam, gemm="bf16")[1]
                              ).all()
        with pytest.raises(ValueError, match="gemm"):
            ops.cdist_exp(a, a, rt, lam, gemm="fp16")
    elif call == "sinkhorn_fused_all":
        assert torch.isfinite(ops.sinkhorn_fused_all(gt, vt, rt, lam, 2,
                                                     tol=1e-3)).all()
        with pytest.raises(ValueError, match="check_every"):
            ops.sinkhorn_fused_all(gt, vt, rt, lam, 2, tol=1e-3,
                                   check_every=0)
    else:
        from repro_torch.core.sparse import PaddedDocs
        docs = PaddedDocs(torch.zeros((2, 1)).long(), torch.ones((2, 1)))
        assert torch.isfinite(ops.sinkhorn_wmd_kernel(
            rt, a, a, docs, lam, 2, tol=1e-3, precision="bf16")).all()
        with pytest.raises(ValueError, match="fp16"):
            ops.sinkhorn_wmd_kernel(rt, a, a, docs, lam, 2,
                                    precision="fp16")


@pytest.mark.parametrize("v_r,v,w", [(8, 256, 128), (19, 512, 300),
                                     (64, 1024, 256), (23, 200, 61),
                                     (70, 300, 300)])
@pytest.mark.parametrize("mode", ["k_only", "log_k"])
def test_cdist_exp_bf16_plain_matches_pallas(rng, v_r, v, w, mode):
    """gemm="bf16": bf16 operands for a.b, fp32 norms and sums, against
    the Pallas kernel (the reference's wrapper takes gemm under k_only)
    at tests/test_kernels.py's K3 tolerance; bf16 moves M by far more."""
    a = rng.standard_normal((v_r, w)).astype(np.float32)
    b = rng.standard_normal((v, w)).astype(np.float32)
    r = rng.uniform(0.01, 1.0, v_r).astype(np.float32)
    lam, log_k = 5.0, mode == "log_k"
    got = ops.cdist_exp(*_t(a, b, r), lam, k_only=True, log_k=log_k,
                        gemm="bf16")
    want = ref_ops.cdist_exp(jnp.asarray(a), jnp.asarray(b), jnp.asarray(r),
                             lam, interpret=True, k_only=True, log_k=log_k,
                             gemm="bf16")
    tol = dict(rtol=2e-3, atol=lam * 5e-3) if log_k else K3_TOL
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    m32, _, _ = ops.cdist_exp(*_t(a, b, r), lam)
    m16, _, _ = ops.cdist_exp(*_t(a, b, r), lam, gemm="bf16")
    assert float((m32 - m16).abs().max()) > 1e-3


def test_one_query_wrappers_validate_inputs(rng):
    g, val, r, lam = map(np.asarray, _k4_inputs(rng, 4, 8, 3, False))
    gt, vt, rt = _t(g, val, r)
    a = gt[:, 0].contiguous()                          # (4, 3)
    with pytest.raises(ValueError, match="shape mismatch"):
        ops.cdist_exp(a, gt[0].T.contiguous(), rt, lam)   # w differs
    with pytest.raises(TypeError):
        ops.cdist_exp(a.double(), a.double(), rt, lam)
    with pytest.raises(ValueError, match="shape mismatch"):
        ops.sinkhorn_fused_all(gt, vt[:, :2].contiguous(), rt, lam, 2)
    with pytest.raises(ValueError, match="3-D"):
        ops.sinkhorn_fused_all(gt[None], vt, rt, lam, 2)
    with pytest.raises(ValueError, match="shape mismatch"):
        ops.sddmm_spmm_step(gt, gt, vt, torch.ones((4, 7)))
