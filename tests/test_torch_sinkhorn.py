"""The port's solvers (``repro_torch.core.sinkhorn``, ``.sinkhorn_sparse``,
``.exact_ot``) against the reference's on the same seeded numpy inputs.

Tolerances: both packages make M with fp32 GEMMs that sum in different
orders (ROADMAP queue 3, P1), so distances agree to ~2e-5 relative on
``small_corpus``; they are held at 1e-4, and tighter where no distance
is formed.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import sinkhorn as ref_sk
from repro.core import sinkhorn_sparse as ref_ss
from repro.core.exact_ot import exact_emd as ref_exact_emd
from repro.core.sparse import padded_docs_to_dense as ref_to_dense
from repro_torch.core import sinkhorn as sk
from repro_torch.core import sinkhorn_sparse as ss
from repro_torch.core.exact_ot import exact_emd
from repro_torch.core.sparse import PaddedDocs, padded_docs_to_dense

TOL = dict(rtol=1e-4, atol=1e-4)


def _support(corpus, qi, lam=None):
    """(numpy r, vecs_sel) of query ``qi`` and the same as tensors."""
    r, sel, _ = sk.select_support(corpus.queries[qi], corpus.vecs)
    return (r, sel), (torch.from_numpy(r), torch.from_numpy(sel))


def _docs(corpus):
    return PaddedDocs(idx=torch.as_tensor(np.array(corpus.docs.idx)).long(),
                      val=torch.as_tensor(np.array(corpus.docs.val)))


def test_select_support_gathers_on_the_tensor_device(small_corpus):
    q = small_corpus.queries[0]
    vecs = torch.from_numpy(small_corpus.vecs)
    r, sel, idx = sk.select_support(q, vecs)
    want_r, want_sel, want_idx = ref_sk.select_support(q, small_corpus.vecs)
    assert isinstance(r, torch.Tensor) and isinstance(sel, torch.Tensor)
    assert r.device == vecs.device and sel.device == vecs.device
    assert sel.dtype == torch.float32
    np.testing.assert_array_equal(idx, want_idx)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(want_sel))
    np.testing.assert_allclose(r.numpy(), np.asarray(want_r), rtol=1e-7)
    # numpy in, numpy out, through the same gather
    r_np, sel_np, _ = sk.select_support(q, small_corpus.vecs)
    assert isinstance(r_np, np.ndarray) and isinstance(sel_np, np.ndarray)
    np.testing.assert_array_equal(sel_np, sel.numpy())


@pytest.mark.parametrize("gemm", ["fp32", "bf16"])
def test_cdist_matches_reference(rng, gemm):
    a = rng.standard_normal((9, 24)).astype(np.float32)
    b = rng.standard_normal((70, 24)).astype(np.float32)
    gd = ss.SolvePrecision(gemm=gemm).gemm_dtype
    ref_gd = ref_ss.SolvePrecision(gemm=gemm).gemm_dtype
    np.testing.assert_allclose(
        sk.cdist(torch.from_numpy(a), torch.from_numpy(b), gd).numpy(),
        np.asarray(ref_sk.cdist(jnp.asarray(a), jnp.asarray(b), ref_gd)),
        rtol=1e-5, atol=1e-5)


# M below this is an exact word match, where P1 leaves a few ulps of
# |a|^2+|b|^2 after the cancellation (up to ~3e-3 of distance here):
# there M is held in squared distance, and the functions of M on the
# other entries
NEAR = 0.1
SQ_RTOL = 1e-5


def _hold_m(m, m_want, a, b):
    scale = (a * a).sum(-1)[:, None] + (b * b).sum(-1)[None, :]
    assert np.all(np.abs(m * m - m_want * m_want) <= SQ_RTOL * scale)
    return m_want > NEAR


def test_precompute_matches_reference(small_corpus):
    (r, sel), (rt, selt) = _support(small_corpus, 0)
    lam = 3.0
    got = sk.precompute(rt, selt, torch.from_numpy(small_corpus.vecs), lam)
    want = ref_sk.precompute(jnp.asarray(r), jnp.asarray(sel),
                             jnp.asarray(small_corpus.vecs), lam)
    assert got._fields == want._fields
    far = _hold_m(got.M.numpy(), np.asarray(want.M), sel, small_corpus.vecs)
    assert (~far).any()                  # the query words are vocabulary
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy()[far], np.asarray(w)[far],
                                   rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("log", [False, True])
def test_precompute_sparse_matches_reference(small_corpus, log):
    (r, sel), (rt, selt) = _support(small_corpus, 1)
    lam = 4.0
    fn, ref_fn = ((ss.precompute_sparse_log, ref_ss.precompute_sparse_log)
                  if log else (ss.precompute_sparse, ref_ss.precompute_sparse))
    got = fn(rt, selt, torch.from_numpy(small_corpus.vecs),
             _docs(small_corpus), lam)
    want = ref_fn(jnp.asarray(r), jnp.asarray(sel),
                  jnp.asarray(small_corpus.vecs), small_corpus.docs, lam)
    assert got._fields == want._fields
    assert set(ss.SparsePrecompute._fields) == {"G", "G_over_r", "val"}
    # slots whose doc word is within NEAR of some query word are held
    # through M (test_precompute_matches_reference)
    m = np.asarray(ref_sk.cdist(jnp.asarray(sel),
                                jnp.asarray(small_corpus.vecs)))
    far = m[:, np.asarray(small_corpus.docs.idx)] > NEAR      # (v_r, N, L)
    col_far = far.all(axis=0)                                 # (N, L)
    for name, g, w in zip(got._fields, got, want):
        g, w = g.numpy(), np.asarray(w)
        sel_mask = col_far if name in ("val", "shift") else (
            far & col_far[None])
        np.testing.assert_allclose(g[sel_mask], w[sel_mask], rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.parametrize("precision,lam", [("fp32", 1.0), ("fp32", 4.0),
                                           ("bf16", 1.0), ("log", 4.0),
                                           ("bf16+log", 1.0)])
def test_sinkhorn_wmd_sparse_matches_reference(small_corpus, precision,
                                               lam):
    (r, sel), (rt, selt) = _support(small_corpus, 0)
    got, iters = ss.sinkhorn_wmd_sparse(
        rt, selt, torch.from_numpy(small_corpus.vecs), _docs(small_corpus),
        lam, 15, precision=precision, return_iters=True)
    want = ref_ss.sinkhorn_wmd_sparse(
        jnp.asarray(r), jnp.asarray(sel), jnp.asarray(small_corpus.vecs),
        small_corpus.docs, lam, 15, precision=precision)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert iters == 15


def test_sinkhorn_wmd_sparse_unfused_matches_reference(small_corpus):
    (r, sel), (rt, selt) = _support(small_corpus, 2)
    got = ss.sinkhorn_wmd_sparse_unfused(
        rt, selt, torch.from_numpy(small_corpus.vecs), _docs(small_corpus),
        2.0, 12)
    want = ref_ss.sinkhorn_wmd_sparse_unfused(
        jnp.asarray(r), jnp.asarray(sel), jnp.asarray(small_corpus.vecs),
        small_corpus.docs, 2.0, 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_sinkhorn_wmd_sparse_tol_is_not_ported(small_corpus):
    """tol runs the adaptive loop (tests/test_torch_adaptive.py holds it
    against the reference); a check period below 1 raises."""
    (r, sel), (rt, selt) = _support(small_corpus, 0)
    vecs = torch.from_numpy(small_corpus.vecs)
    got, it = ss.sinkhorn_wmd_sparse(rt, selt, vecs, _docs(small_corpus),
                                     1.0, 15, tol=1e-3, check_every=2,
                                     return_iters=True)
    want, want_it = ref_ss.sinkhorn_wmd_sparse(
        jnp.asarray(r), jnp.asarray(sel), jnp.asarray(small_corpus.vecs),
        small_corpus.docs, 1.0, 15, tol=1e-3, check_every=2,
        return_iters=True)
    assert it == int(want_it) and (it - 1) % 2 == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="check_every"):
        ss.sinkhorn_wmd_sparse(rt, selt, vecs, _docs(small_corpus), 1.0, 5,
                               tol=1e-3, check_every=0)


@pytest.mark.parametrize("stabilized", [False, True])
def test_dense_solvers_match_reference(small_corpus, stabilized):
    (r, sel), (rt, selt) = _support(small_corpus, 1)
    v = small_corpus.vecs.shape[0]
    c = ref_to_dense(small_corpus.docs, v)
    fn, ref_fn = ((sk.sinkhorn_wmd_dense_stabilized,
                   ref_sk.sinkhorn_wmd_dense_stabilized) if stabilized
                  else (sk.sinkhorn_wmd_dense, ref_sk.sinkhorn_wmd_dense))
    got = fn(rt, selt, torch.from_numpy(small_corpus.vecs),
             padded_docs_to_dense(_docs(small_corpus), v), 4.0, 20)
    want = ref_fn(jnp.asarray(r), jnp.asarray(sel),
                  jnp.asarray(small_corpus.vecs), jnp.asarray(c), 4.0, 20)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_padded_docs_to_dense_on_tensors(small_corpus):
    v = small_corpus.vecs.shape[0]
    got = padded_docs_to_dense(_docs(small_corpus), v)
    assert isinstance(got, torch.Tensor)
    want = ref_to_dense(small_corpus.docs, v)
    np.testing.assert_array_equal(got.numpy(), want)
    # numpy in, numpy out
    got_np = padded_docs_to_dense(PaddedDocs(idx=np.asarray(
        small_corpus.docs.idx), val=np.asarray(small_corpus.docs.val)), v)
    assert isinstance(got_np, np.ndarray)
    np.testing.assert_array_equal(got_np, want)


def test_exact_emd_matches_reference(rng):
    r = rng.random(5)
    c = rng.random(7)
    m = rng.random((5, 7))
    r, c = r / r.sum(), c / c.sum()
    assert exact_emd(r, c, m) == pytest.approx(ref_exact_emd(r, c, m),
                                               rel=1e-9)


@pytest.mark.parametrize("lam", [9.0, 11.0])
def test_dense_fp32_underflow_vs_stabilized(lam):
    """tests/test_sinkhorn.py's LP-oracle check on the port. The log-domain
    iteration stays within a few permil of the exact LP. The fp32
    scaling-vector iteration does too at lam=9, where the reference's
    loses 2.5e-2 (ROADMAP queue 3, P2): torch's exp keeps K's fp32
    denormals down to exp(-103). Past that, at lam=11, whole K columns
    are 0 and it raises."""
    from repro_torch.core import LamUnderflowError, one_to_many
    from repro_torch.data.corpus import make_corpus
    corp = make_corpus(vocab_size=512, embed_dim=32, n_docs=64, n_queries=3,
                       seed=7)
    q = corp.queries[1]
    r, sel, _ = sk.select_support(q, corp.vecs)
    m = sk.cdist(torch.from_numpy(sel), torch.from_numpy(corp.vecs)).numpy()
    c_dense = padded_docs_to_dense(corp.docs, 512)
    ds = one_to_many(q, corp.docs, corp.vecs, lam, 800,
                     impl="dense_stabilized", device="cpu").numpy()
    for j in (30, 44):             # the docs farthest from the LP in each
        col = c_dense[:, j]
        supp = np.nonzero(col > 0)[0]
        exact = exact_emd(r, col[supp], m[:, supp])
        assert abs(ds[j] - exact) / exact < 5e-3
        if lam == 9.0:
            dd = one_to_many(q, corp.docs, corp.vecs, lam, 800,
                             impl="dense", device="cpu").numpy()
            assert abs(dd[j] - exact) / exact < 5e-3
    if lam == 11.0:
        with pytest.raises(LamUnderflowError):
            one_to_many(q, corp.docs, corp.vecs, lam, 800, impl="dense",
                        device="cpu")
