"""The port's engine against the reference's ``impl="kernel"`` engine on
one corpus: the reference index is carried across with
``index_from_arrays``, so both engines search the same storage order.

Tolerances: the two engines make the K block with two fp32 GEMMs that sum
in different orders. Where a query word is also a doc word the distance
is sqrt of a cancelled |a|^2+|b|^2-2a.b, so the residue of a few ulps
becomes ~1e-3 of distance, which the distance line carries at a size that
grows with lam: measured 3.7e-5 relative at lam=1, n_iter=10 and ~1e-4 at
lam=2..8. So lam=1 is held at rtol=1e-4, atol=1e-5, and the larger lam no
tighter than the reference's own batched-vs-looped spread (ROADMAP queue
3, R2: 9.3e-4 relative).
"""
import os
import tempfile

import numpy as np
import pytest
import torch

from repro.core.index import WmdEngine as RefEngine
from repro.core.index import build_index as ref_build_index
from repro.core.index import save_index
from repro_torch.core.index import WmdEngine, build_index, index_from_arrays
from repro_torch.core.sinkhorn import LamUnderflowError
from repro_torch.core.sparse import PaddedDocs

TIGHT = dict(rtol=1e-4, atol=1e-5)      # lam <= 1, n_iter <= 10
R2 = dict(rtol=1e-3, atol=5e-3)         # larger lam: the reference's spread
PRUNES = [None, "wcd", "rwmd", "wcd+rwmd"]


@pytest.fixture(scope="module")
def carried(small_corpus):
    """(reference index, the port's CPU index carried across from it)."""
    ref_index = ref_build_index(small_corpus.docs, small_corpus.vecs)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "index.npz")
        save_index(ref_index, path)
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files}
    return ref_index, index_from_arrays(arrays, device="cpu")


def test_index_from_arrays_keeps_storage_order(carried):
    ref_index, index = carried
    np.testing.assert_array_equal(index.docs_host.idx,
                                  np.asarray(ref_index.docs_host.idx))
    np.testing.assert_array_equal(index.ext_ids, ref_index.ext_ids)
    assert len(index.groups) == len(ref_index.groups)
    for g, rg in zip(index.groups, ref_index.groups):
        np.testing.assert_array_equal(g.cols, np.asarray(rg.cols))
        np.testing.assert_array_equal(g.docs.idx.numpy(),
                                      np.asarray(rg.docs.idx))
    assert index.device == torch.device("cpu")


@pytest.mark.parametrize("lam,n_iter,tol", [(1.0, 10, TIGHT),
                                            (8.0, 12, R2)])
def test_query_batch_matches_reference_kernel_engine(small_corpus, carried,
                                                     lam, n_iter, tol):
    ref_index, index = carried
    qs = list(small_corpus.queries)
    want = np.asarray(RefEngine(ref_index, lam=lam, n_iter=n_iter,
                                impl="kernel").query_batch(qs))
    got = WmdEngine(index, lam=lam, n_iter=n_iter).query_batch(qs)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **tol)


@pytest.fixture(scope="module")
def ref_searches(small_corpus, carried):
    ref_index, _ = carried
    eng = RefEngine(ref_index, lam=1.0, n_iter=10, impl="kernel")
    return {p: eng.search(list(small_corpus.queries), 5, prune=p)
            for p in PRUNES}


@pytest.mark.parametrize("prune", PRUNES)
def test_search_matches_reference_and_exhaustive(small_corpus, carried,
                                                 ref_searches, prune):
    _, index = carried
    qs = list(small_corpus.queries)
    eng = WmdEngine(index, lam=1.0, n_iter=10)
    got = eng.search(qs, 5, prune=prune)
    want = ref_searches[prune]
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_allclose(got.distances, want.distances, **TIGHT)
    full = eng.query_batch(qs).numpy()
    order = np.argsort(full, axis=1, kind="stable")[:, :5]
    np.testing.assert_array_equal(got.indices, order)
    np.testing.assert_allclose(got.distances,
                               np.take_along_axis(full, order, 1),
                               rtol=1e-6, atol=1e-6)
    assert (got.solved <= index.n_docs).all() and (got.solved >= 5).all()


def test_log_precision_where_fp32_underflows(small_corpus, carried):
    """At lam=30 fp32 K underflows on this corpus: the reference's einsum
    engine raises LamUnderflowError and so does the port (its kernel
    engine returns finite wrong distances, ROADMAP queue 3); the log
    domain matches the reference's log-domain kernel engine."""
    ref_index, index = carried
    qs = list(small_corpus.queries)
    with pytest.raises(FloatingPointError):       # LamUnderflowError
        RefEngine(ref_index, lam=30.0, n_iter=8,
                  impl="sparse").query_batch(qs)
    with pytest.raises(LamUnderflowError, match="underflowed"):
        WmdEngine(index, lam=30.0, n_iter=8).query_batch(qs)
    with pytest.raises(LamUnderflowError):
        WmdEngine(index, lam=30.0, n_iter=8).search(qs, 3)
    want = np.asarray(RefEngine(ref_index, lam=30.0, n_iter=8,
                                impl="kernel",
                                precision="log").query_batch(qs))
    eng = WmdEngine(index, lam=30.0, n_iter=8, precision="log")
    got = eng.query_batch(qs).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **R2)
    res = eng.search(qs, 5, prune="rwmd")
    order = np.argsort(got, axis=1, kind="stable")[:, :5]
    np.testing.assert_array_equal(res.indices, order)


def test_own_build_index_gives_same_search(small_corpus, carried):
    """The port's torch k-means may settle near-ties differently from the
    reference's; by the index's exactness contract no distance moves."""
    _, index = carried
    qs = list(small_corpus.queries)
    own = build_index(PaddedDocs(np.asarray(small_corpus.docs.idx),
                                 np.asarray(small_corpus.docs.val)),
                      small_corpus.vecs, device="cpu")
    assert own.n_docs == index.n_docs
    assert sorted(own.ext_ids.tolist()) == list(range(own.n_docs))
    a = WmdEngine(own, lam=1.0, n_iter=10)
    b = WmdEngine(index, lam=1.0, n_iter=10)
    ra, rb = a.search(qs, 5), b.search(qs, 5)
    np.testing.assert_array_equal(ra.indices, rb.indices)
    np.testing.assert_allclose(ra.distances, rb.distances, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(a.query_batch(qs).numpy(),
                               b.query_batch(qs).numpy(), rtol=1e-6,
                               atol=1e-6)


def test_edge_queries_and_unported_options(small_corpus, carried):
    _, index = carried
    empty = np.zeros(small_corpus.vecs.shape[0], np.float32)
    eng = WmdEngine(index, lam=1.0, n_iter=5)
    res = eng.search([small_corpus.queries[0], empty], 3)
    assert (res.indices[1] == -1).all() and np.isnan(res.distances[1]).all()
    assert res.solved[1] == 0
    assert np.isnan(eng.query_batch([empty]).numpy()).all()
    assert eng.search([], 3).indices.shape == (0, 3)
    with pytest.raises(ValueError):
        eng.search([small_corpus.queries[0]], 0)
    # the einsum impl and its K-column cache are ported
    # (tests/test_torch_einsum.py, tests/test_torch_kcache.py); the cache
    # needs the einsum impl
    for kw in (dict(impl="sparse"), dict(impl="sparse", kcache_slots=8)):
        assert WmdEngine(index, lam=1.0, n_iter=5, **kw).search(
            [small_corpus.queries[0]], 3).indices.shape == (1, 3)
    with pytest.raises(ValueError, match="sparse"):
        WmdEngine(index, kcache_slots=8)
    # the adaptive and bf16 solve are ported (tests/test_torch_adaptive.py)
    for kw in (dict(tol=1e-3), dict(precision="bf16"),
               dict(warm_start=True), dict(scope="chunk")):
        assert WmdEngine(index, lam=1.0, n_iter=5, **kw).search(
            [small_corpus.queries[0]], 3).indices.shape == (1, 3)
    # the IVF cascade and refine mode are ported (tests/test_torch_cascade.py)
    casc = eng.search([small_corpus.queries[0], empty], 3,
                      prune="ivf+wcd+rwmd")
    np.testing.assert_array_equal(casc.indices[0], res.indices[0])
    assert (casc.indices[1] == -1).all() and casc.solved[1] == 0
    with pytest.raises(ValueError, match="refine"):
        eng.search([small_corpus.queries[0]], 3, prune=None, mode="refine")
    with pytest.raises(ValueError):
        eng.search([small_corpus.queries[0]], 3, prune="nope")
