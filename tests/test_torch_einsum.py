"""The port's einsum engine (``WmdEngine(impl="sparse")``) and its warm
start on the CPU, against the reference's ``impl="sparse"`` engine.

The reference index is carried across with ``index_from_arrays``, so both
packages search the same storage order, groups and clusters. Tolerances,
each with its source (ROADMAP queue 3):

- ``SOLVE``: :func:`_solve_batched_einsum` against the reference's on the
  same gathered G and M (no GEMM in between): the two sum the einsums in
  other orders, over up to 60 iterations; measured ~1e-6 relative.
  With bf16 operands (``SOLVE_BF16``) an fp32 value one ulp apart between
  the two can round to bf16 values one bf16 ulp (2**-8) apart: measured
  2.8e-5 relative on one distance, held at 1e-4.
- ``TIGHT``: the engines on ``small_corpus`` at lam <= 1 make their K
  blocks with fp32 GEMMs that sum in other orders (P1): 3.7e-5 relative
  measured, held at 1e-4 as ``tests/test_torch_engine.py`` does.
- ``R2``: at lam=8, and on the dedup corpus where P1 sits in nearly every
  distance (1.3e-3 relative), the reference's own batched-vs-looped
  spread.
"""
import os
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax.numpy as jnp  # noqa: E402
from benchmarks.fig8_topk_prune import dedup_corpus as ref_dedup_corpus  # noqa: E402
from repro.core import index as ref_index_mod  # noqa: E402
from repro.core.index import WmdEngine as RefEngine  # noqa: E402
from repro.core.index import build_index as ref_build_index  # noqa: E402
from repro.core.index import save_index  # noqa: E402
from repro.core.wmd import many_to_many as ref_many_to_many  # noqa: E402
from repro.core.wmd import search as ref_search  # noqa: E402
from repro_torch.core import index as index_mod  # noqa: E402
from repro_torch.core import many_to_many, search  # noqa: E402
from repro_torch.core.index import WmdEngine, index_from_arrays  # noqa: E402
from repro_torch.core.sinkhorn import LamUnderflowError  # noqa: E402

SOLVE = dict(rtol=2e-5, atol=2e-6)
SOLVE_BF16 = dict(rtol=1e-4, atol=1e-5)
TIGHT = dict(rtol=1e-4, atol=1e-5)
R2 = dict(rtol=1e-3, atol=5e-3)
PRUNES = [None, "wcd", "rwmd", "wcd+rwmd", "ivf", "ivf+wcd", "ivf+rwmd",
          "ivf+wcd+rwmd", "ivf+pivot+wcd+rwmd", "ivf+pivot+rwmd"]
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
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "index.npz")
        save_index(ref_index, path)
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files}
    return index_from_arrays(arrays, device="cpu")


@pytest.fixture(scope="module")
def small(small_corpus):
    ref_index = ref_build_index(small_corpus.docs, small_corpus.vecs)
    return ref_index, _carry(ref_index)


@pytest.fixture(scope="module")
def dedup():
    return ref_dedup_corpus(256, vocab=1024, embed_dim=32, seed=5)


@pytest.fixture(scope="module")
def dedup_indexes(dedup):
    ref_index = ref_build_index(dedup.docs, dedup.vecs)
    return ref_index, _carry(ref_index)


# ------------------------------------------------- the solve on one chunk
def _chunk(ref_index, queries, lam, log_domain):
    """The reference's staged first chunk against its widest doc group, as
    numpy: (g (Q, N, L, B), mq (Q, V, B), idx, val, r, mask)."""
    eng = RefEngine(ref_index, lam=lam, impl="sparse")
    _, chunks = eng._plan(queries)
    chunk, width = chunks[0]
    sup, r, mask = eng._prep_chunk([queries[qi] for qi in chunk], width)
    kq, mq = ref_index_mod._compute_kq(sup, mask, ref_index.vecs,
                                       ref_index.vecs_sq, lam,
                                       log_domain=log_domain)
    grp = max(ref_index.groups, key=lambda g: g.docs.idx.shape[1])
    g = ref_index_mod._gather_g(kq, grp.docs.idx, layout="qnlb")
    return tuple(np.asarray(a) for a in (g, mq, grp.docs.idx, grp.docs.val,
                                         r, mask))


SOLVE_CASES = {
    "fixed": dict(lam=1.0, n_iter=15),
    "log": dict(lam=8.0, n_iter=15, log_domain=True),
    "bf16": dict(lam=1.0, n_iter=15, gemm="bf16"),
    "bf16+log": dict(lam=8.0, n_iter=15, gemm="bf16", log_domain=True),
    "chunk": dict(**FIG10, scope="chunk"),
    "query": dict(**PQ, scope="query"),
    "query_bf16": dict(**FIG10, scope="query", gemm="bf16"),
}


@pytest.mark.parametrize("case", sorted(SOLVE_CASES))
def test_solve_matches_reference(dedup, dedup_indexes, case):
    """Every option of the solve, with the profile and a warm start from
    it, on the same G and M as the reference's."""
    kw = dict(SOLVE_CASES[case])
    lam, n_iter = kw.pop("lam"), kw.pop("n_iter")
    ref_index, _ = dedup_indexes
    arrays = _chunk(ref_index, list(dedup.queries), lam,
                    kw.get("log_domain", False))
    q, n = arrays[0].shape[:2]
    qdoc = np.zeros((q, n), bool)
    qdoc[:, : n // 2] = True           # a scope narrower than the group
    if kw.get("scope") == "query":
        kw["qdoc_mask"] = qdoc
    j = [jnp.asarray(a) for a in arrays]
    t = [torch.from_numpy(np.array(a)) for a in arrays]
    t[2] = t[2].long()
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    tol = SOLVE_BF16 if kw.get("gemm") == "bf16" else SOLVE
    want = ref_index_mod._solve_batched_einsum(
        *j, lam, n_iter, with_profile=True, prof_mask=jnp.asarray(qdoc),
        **kw)
    got = index_mod._solve_batched_einsum(
        *t, lam, n_iter, with_profile=True,
        prof_mask=torch.from_numpy(qdoc), **tkw)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **tol)
    np.testing.assert_array_equal(np.asarray(torch.as_tensor(got[1])),
                                  np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), **tol)
    if "tol" in kw or "scope" in kw:
        return
    # warm start from that profile (the survivor solve's input)
    x0 = np.asarray(want[2])
    want_w = ref_index_mod._solve_batched_einsum(*j, lam, n_iter,
                                                 x0q=jnp.asarray(x0), **kw)
    got_w = index_mod._solve_batched_einsum(*t, lam, n_iter,
                                            x0q=torch.from_numpy(x0), **tkw)
    np.testing.assert_allclose(got_w[0].numpy(), np.asarray(want_w[0]),
                               **tol)


def test_solve_linear_underflow_is_nan():
    """The linear domain keeps the raw val/t: a K column that underflowed
    to zero turns the distance NaN (the engine raises on it)."""
    g = torch.zeros((1, 2, 3, 4))
    g[0, 0] = 0.5
    mq = torch.ones((1, 10, 4))
    idx = torch.zeros((2, 3), dtype=torch.int64)
    val = torch.full((2, 3), 1 / 3)
    r = torch.full((1, 4), 0.25)
    mask = torch.ones((1, 4))
    wmd, _ = index_mod._solve_batched_einsum(g, mq, idx, val, r, mask, 1.0,
                                             5)
    assert torch.isfinite(wmd[0, 0]) and torch.isnan(wmd[0, 1])


# -------------------------------------------------------- the engine
def _search_pair(ref_eng, eng, queries, k, prune, **kw):
    return (ref_eng.search(queries, k, prune=prune, **kw),
            eng.search(queries, k, prune=prune, **kw))


def _hold(got, want, tol):
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.solved, want.solved)
    np.testing.assert_allclose(got.distances, want.distances, **tol)


@pytest.mark.parametrize("lam,n_iter,tol", [(1.0, 10, TIGHT),
                                            (8.0, 12, R2)])
def test_query_batch_matches_reference(small_corpus, small, lam, n_iter,
                                       tol):
    ref_index, index = small
    qs = list(small_corpus.queries)
    want = np.asarray(RefEngine(ref_index, lam=lam, n_iter=n_iter,
                                impl="sparse").query_batch(qs))
    got = WmdEngine(index, lam=lam, n_iter=n_iter,
                    impl="sparse").query_batch(qs)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **tol)


@pytest.fixture(scope="module")
def small_engines(small):
    ref_index, index = small
    return (RefEngine(ref_index, lam=1.0, n_iter=10, impl="sparse"),
            WmdEngine(index, lam=1.0, n_iter=10, impl="sparse"))


@pytest.mark.parametrize("prune", PRUNES)
def test_search_matches_reference(small_corpus, small_engines, prune):
    ref_eng, eng = small_engines
    want, got = _search_pair(ref_eng, eng, list(small_corpus.queries), 5,
                             prune)
    _hold(got, want, TIGHT)
    exhaustive = eng.search(list(small_corpus.queries), 5, prune=None)
    np.testing.assert_array_equal(got.indices, exhaustive.indices)


@pytest.mark.parametrize("prune", ["rwmd", "ivf+pivot+wcd+rwmd"])
@pytest.mark.parametrize("rf", [1, 4])
def test_refine_matches_reference(small_corpus, small_engines, prune, rf):
    ref_eng, eng = small_engines
    want, got = _search_pair(ref_eng, eng, list(small_corpus.queries), 5,
                             prune, mode="refine", refine_factor=rf)
    _hold(got, want, TIGHT)


@pytest.mark.parametrize("precision", ["log", "bf16", "bf16+log"])
def test_precisions_match_reference(small_corpus, small, precision):
    ref_index, index = small
    qs = list(small_corpus.queries)
    kw = dict(lam=1.0, n_iter=10, impl="sparse", precision=precision)
    want = RefEngine(ref_index, **kw).search(qs, 5, prune="ivf+wcd+rwmd")
    got = WmdEngine(index, **kw).search(qs, 5, prune="ivf+wcd+rwmd")
    _hold(got, want, TIGHT)


@pytest.mark.parametrize("scope", ["query", "chunk"])
@pytest.mark.parametrize("prune", ["rwmd", "ivf+wcd+rwmd"])
def test_adaptive_iter_stats_match_reference(dedup, dedup_indexes, scope,
                                             prune):
    """Realized counts per stage and query, ``solved`` and the top-k at
    fig10's operating point on the dedup corpus (P1 sits in its
    distances, so they are held at R2)."""
    ref_index, index = dedup_indexes
    qs = list(dedup.queries)
    ref_eng = RefEngine(ref_index, impl="sparse", scope=scope, **FIG10)
    eng = WmdEngine(index, impl="sparse", scope=scope, **FIG10)
    want, got = _search_pair(ref_eng, eng, qs, 10, prune)
    _hold(got, want, R2)
    sw, sg = ref_eng.iter_stats_by_stage(), eng.iter_stats_by_stage()
    assert list(sg) == list(sw)
    for st in sw:
        np.testing.assert_array_equal(sg[st], sw[st])
    np.testing.assert_array_equal(
        eng.query_batch(qs).numpy().shape, (len(qs), index.n_docs))


def test_staged_equals_exhaustive_under_tol(dedup, dedup_indexes):
    _, index = dedup_indexes
    qs = list(dedup.queries)
    eng = WmdEngine(index, impl="sparse", scope="chunk", **FIG10)
    full = eng.query_batch(qs).numpy()
    res = eng.search(qs, 10, prune="rwmd")
    order = np.argsort(full, axis=1, kind="stable")[:, :10]
    assert {tuple(sorted(r)) for r in res.indices} == \
        {tuple(sorted(r)) for r in order}


# ------------------------------------------------------- warm start
def test_warm_survivor_matches_cold_with_fewer_iters(dedup, dedup_indexes):
    """tests/test_convergence_scoped.py's contract on the port: the warm
    survivor solve lands within tol of the cold one's fixed point (the
    same band) in fewer realized iterations, the seed stage unchanged;
    and the port's warm counts are the reference's."""
    ref_index, index = dedup_indexes
    qs = list(dedup.queries)
    cold = WmdEngine(index, impl="sparse", warm_start=False, **PQ)
    warm = WmdEngine(index, impl="sparse", warm_start=True, **PQ)
    r_c = cold.search(qs, 10, prune="rwmd")
    r_w = warm.search(qs, 10, prune="rwmd")
    np.testing.assert_allclose(np.sort(r_w.distances, axis=1),
                               np.sort(r_c.distances, axis=1),
                               rtol=5e-2, atol=1e-3)
    sc, sw = cold.iter_stats_by_stage(), warm.iter_stats_by_stage()
    np.testing.assert_array_equal(sw["seed"], sc["seed"])
    assert sw["survivor"].mean() < sc["survivor"].mean(), (sc, sw)
    ref_warm = RefEngine(ref_index, impl="sparse", warm_start=True, **PQ)
    ref_w = ref_warm.search(qs, 10, prune="rwmd")
    # membership equal; near-duplicates tie within P1, so order may not be
    assert ([set(row) for row in r_w.indices.tolist()]
            == [set(row) for row in ref_w.indices.tolist()])
    np.testing.assert_allclose(np.sort(r_w.distances, axis=1),
                               np.sort(ref_w.distances, axis=1), **R2)
    np.testing.assert_array_equal(warm.iter_stats("survivor"),
                                  ref_warm.iter_stats("survivor"))


def test_warm_start_in_the_cascade(dedup, dedup_indexes):
    """The cascade's warm survivors (each query's own seed picks feed its
    profile) against the reference's, at fig10's point."""
    ref_index, index = dedup_indexes
    qs = list(dedup.queries)
    kw = dict(impl="sparse", warm_start=True, **FIG10)
    ref_eng, eng = RefEngine(ref_index, **kw), WmdEngine(index, **kw)
    want, got = _search_pair(ref_eng, eng, qs, 10, "ivf+wcd+rwmd")
    _hold(got, want, R2)
    for st, arr in ref_eng.iter_stats_by_stage().items():
        np.testing.assert_array_equal(eng.iter_stats(st), arr)


def test_warm_start_inert_without_tol(dedup, dedup_indexes):
    """With tol=None warm_start changes nothing, bit for bit."""
    _, index = dedup_indexes
    qs = list(dedup.queries[:2])
    a = WmdEngine(index, lam=1.0, n_iter=15, impl="sparse",
                  warm_start=False).search(qs, 8, prune="rwmd")
    b = WmdEngine(index, lam=1.0, n_iter=15, impl="sparse",
                  warm_start=True).search(qs, 8, prune="rwmd")
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.distances, b.distances)


# ------------------------------------------ errors and public defaults
def test_linear_underflow_raises(small_corpus, small):
    _, index = small
    with pytest.raises(LamUnderflowError):
        WmdEngine(index, lam=30.0, n_iter=5,
                  impl="sparse").query_batch(list(small_corpus.queries))
    d = WmdEngine(index, lam=30.0, n_iter=5, impl="sparse",
                  precision="log").query_batch(list(small_corpus.queries))
    assert np.isfinite(d.numpy()).all()


def test_impl_choices(small):
    _, index = small
    assert index_mod.ENGINE_IMPLS == ("sparse", "kernel")
    assert WmdEngine(index).impl == "kernel"        # the card's path
    with pytest.raises(ValueError, match="impl"):
        WmdEngine(index, impl="dense")


def test_wmd_defaults_match_reference(small_corpus):
    """many_to_many and wmd.search with their default arguments (impl
    "sparse", lam=10, n_iter=15, prune "rwmd", k=10), only the device
    named: equal to the reference's defaults (R2, at lam=10) on a corpus
    where lam=10 underflows nothing. On ``small_corpus`` the reference's
    fp32 exp flushes K below exp(-87.3) to zero at lam=10 and it raises
    LamUnderflowError; torch keeps those values as denormals, so the port
    returns finite distances there (ROADMAP queue 3, P2)."""
    from repro.data.corpus import make_corpus as ref_make_corpus
    c = ref_make_corpus(vocab_size=256, embed_dim=8, n_docs=48, n_queries=3,
                        seed=2)
    qs = list(c.queries)
    got = many_to_many(qs, c.docs, c.vecs, device="cpu")
    want = ref_many_to_many(qs, c.docs, c.vecs)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **R2)
    _hold(search(qs, c.docs, c.vecs, device="cpu"),
          ref_search(qs, c.docs, c.vecs), R2)
    args = (list(small_corpus.queries), small_corpus.docs, small_corpus.vecs)
    with pytest.raises(ref_index_mod.LamUnderflowError):
        ref_search(*args)
    assert np.isfinite(search(*args, device="cpu").distances).all()
    assert all(torch.isfinite(d).all()
               for d in many_to_many(*args, device="cpu"))
