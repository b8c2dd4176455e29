"""The port's one-query API (``repro_torch.core.wmd``: ``one_to_many``,
``many_to_many``, ``search``) against the reference's on the same seeded
numpy inputs, on the CPU (the kernel impl runs the kernels' plain
versions; the reference's runs its Pallas kernels in interpret mode).

Tolerances: the two packages make M with fp32 GEMMs that sum in
different orders (ROADMAP queue 3, P1): measured ~2e-5 relative on
``small_corpus`` at lam <= 8. Held at 1e-4 up to lam=4, and at the
reference's own batched-vs-looped spread (R2, 1e-3) at lam=8.
"""
import numpy as np
import pytest
import torch

from repro.core import one_to_many as ref_one_to_many
from repro_torch.core import (IMPLS, LamUnderflowError, many_to_many,
                              one_to_many, search)
from repro_torch.core.sparse import PaddedDocs

TIGHT = dict(rtol=1e-4, atol=1e-4)
R2 = dict(rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("lam,n_iter,tol", [(1.0, 15, TIGHT),
                                            (4.0, 20, TIGHT),
                                            (8.0, 12, R2)])
def test_one_to_many_matches_reference(small_corpus, impl, lam, n_iter,
                                       tol):
    q = small_corpus.queries[0]
    got = one_to_many(q, small_corpus.docs, small_corpus.vecs, lam, n_iter,
                      impl=impl, device="cpu")
    want = ref_one_to_many(q, small_corpus.docs, small_corpus.vecs, lam,
                           n_iter, impl=impl)
    assert got.shape == (small_corpus.docs.idx.shape[0],)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("impl", ["sparse", "sparse_unfused", "kernel"])
def test_sparse_impls_match_dense(small_corpus, impl):
    """tests/test_sinkhorn.py's check inside the port: the sparse
    transformation computes the same distances (lam=9, n_iter=40)."""
    q = small_corpus.queries[0]
    args = (q, small_corpus.docs, small_corpus.vecs, 9.0, 40)
    want = one_to_many(*args, impl="dense", device="cpu")
    got = one_to_many(*args, impl=impl, device="cpu")
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("impl", ["dense", "sparse", "sparse_unfused",
                                  "kernel"])
def test_linear_impls_raise_on_underflow(small_corpus, impl):
    """At lam=30 K = exp(-lam*M) is all zero for whole columns: every
    linear impl raises instead of returning NaN; the log-domain dense
    impl returns finite distances."""
    q = small_corpus.queries[0]
    args = (q, small_corpus.docs, small_corpus.vecs, 30.0, 10)
    with pytest.raises(LamUnderflowError, match="underflowed"):
        one_to_many(*args, impl=impl, device="cpu")
    out = one_to_many(*args, impl=impl, device="cpu", check_underflow=False)
    assert torch.isnan(out).any()
    assert torch.isfinite(one_to_many(*args, impl="dense_stabilized",
                                      device="cpu")).all()


def test_one_to_many_takes_tensors_and_numpy_alike(small_corpus):
    q = small_corpus.queries[2]
    docs = PaddedDocs(idx=torch.as_tensor(np.array(small_corpus.docs.idx)),
                      val=torch.as_tensor(np.array(small_corpus.docs.val)))
    vecs = torch.as_tensor(small_corpus.vecs)
    a = one_to_many(q, small_corpus.docs, small_corpus.vecs, 2.0, 10,
                    impl="kernel", device="cpu")
    b = one_to_many(torch.as_tensor(q), docs, vecs, 2.0, 10, impl="kernel",
                    device="cpu")
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="impl must be one of"):
        one_to_many(q, docs, vecs, impl="fused", device="cpu")


def test_many_to_many_kernel_engine_matches_loop(small_corpus):
    qs = list(small_corpus.queries)
    batched = many_to_many(qs, small_corpus.docs, small_corpus.vecs, 1.0,
                           15, impl="kernel", device="cpu")
    looped = many_to_many(qs, small_corpus.docs, small_corpus.vecs, 1.0,
                          15, impl="kernel", batched=False, device="cpu")
    assert len(batched) == len(looped) == len(qs)
    for b, lo in zip(batched, looped):
        np.testing.assert_allclose(b.numpy(), lo.numpy(), **TIGHT)
    for lo, q in zip(looped, qs):
        want = ref_one_to_many(q, small_corpus.docs, small_corpus.vecs, 1.0,
                               15, impl="sparse")
        np.testing.assert_allclose(lo.numpy(), np.asarray(want), **TIGHT)


def test_engine_paths_keep_refusing_the_sparse_impl(small_corpus):
    """The batched engine now runs impl="sparse" too (the einsum solve),
    and agrees with the per-query loop (the sparse solver) and with its
    own exhaustive ranking: many_to_many and search no longer refuse it."""
    qs = list(small_corpus.queries[:2])
    args = (small_corpus.docs, small_corpus.vecs)
    batched = many_to_many(qs, *args, 1.0, 5, impl="sparse", device="cpu")
    looped = many_to_many(qs, *args, 1.0, 5, impl="sparse", batched=False,
                          device="cpu")
    assert all(torch.isfinite(d).all() for d in looped)
    for b, lo in zip(batched, looped):
        np.testing.assert_allclose(b.numpy(), lo.numpy(), **TIGHT)
    res = search(qs, *args, k=3, lam=1.0, n_iter=5, impl="sparse",
                 device="cpu")
    for qi in range(len(qs)):
        order = np.argsort(batched[qi].numpy(), kind="stable")[:3]
        np.testing.assert_array_equal(res.indices[qi], order)


def test_search_matches_exhaustive_one_to_many(small_corpus):
    qs = list(small_corpus.queries)
    res = search(qs, small_corpus.docs, small_corpus.vecs, k=5, lam=1.0,
                 n_iter=15, impl="kernel", device="cpu")
    for qi, q in enumerate(qs):
        d = one_to_many(q, small_corpus.docs, small_corpus.vecs, 1.0, 15,
                        impl="kernel", device="cpu").numpy()
        order = np.argsort(d, kind="stable")[:5]
        np.testing.assert_array_equal(res.indices[qi], order)
        np.testing.assert_allclose(res.distances[qi], d[order], **TIGHT)
