"""The port's cross-request K-column cache on the CPU: every test of
``tests/test_kcache.py`` on the port, whose oracle is the port's own
uncached engine, compared bit for bit (``np.array_equal``); the counters
against the reference's on the same traffic; and the cached rows against
the reference's within a tolerance.

The reference's own cache-on = cache-off tests fail on the installed JAX
(ROADMAP queue 3, R1), so the port is never held to the reference's bits:
``ROW_SQ_RTOL`` holds its rows to the reference's at the squared-distance
tolerance K2 and K3 use (1e-5 of |a|^2 + |b|^2: the two GEMMs sum the
w-long product in other orders), and distances across packages at the
reference's batched-vs-looped spread ``R2``: Zipfian queries draw the hot
words, which are doc words, so P1's cancellation at exact word matches
sits in their distances (1.1e-4 relative measured).
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
from _hypothesis_compat import given, settings, st  # noqa: E402
from benchmarks.fig15_kcache import zipf_queries as ref_zipf_queries  # noqa: E402
from repro.core.index import WmdEngine as RefEngine  # noqa: E402
from repro.core.index import build_index as ref_build_index  # noqa: E402
from repro.core.index import save_index  # noqa: E402
from repro.core.kcache import _cdist_rows as ref_cdist_rows  # noqa: E402
from repro_torch.core import append_docs  # noqa: E402
from repro_torch.core.index import (WmdEngine, _compute_kq,  # noqa: E402
                                    build_index, index_from_arrays)
from repro_torch.core.kcache import (KQ_PANEL, KCache,  # noqa: E402
                                     _cdist_rows, cdist_rows)
from repro_torch.core.sparse import PaddedDocs  # noqa: E402
from repro_torch.data.corpus import make_corpus, zipf_queries  # noqa: E402

LAM = 1.0
N_ITER = 10
VOCAB = 512
ROW_SQ_RTOL = 1e-5
R2 = dict(rtol=1e-3, atol=5e-3)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors: one intra-op thread runs them fastest, also when
    several test workers share the host. Restored when the module ends."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def index(small_corpus):
    return build_index(small_corpus.docs, small_corpus.vecs, device="cpu")


def _engine(index, cached, precision="fp32", slots=256, min_hits=1, **kw):
    return WmdEngine(index, lam=LAM, n_iter=N_ITER, impl="sparse",
                     precision=precision,
                     kcache_slots=slots if cached else None,
                     kcache_min_hits=min_hits, **kw)


def _hist(ids, vocab=VOCAB, seed=0):
    """Query histogram with exactly ``ids`` as support."""
    rng = np.random.default_rng(seed)
    q = np.zeros(vocab, np.float32)
    q[np.asarray(ids)] = rng.random(len(ids)).astype(np.float32) + 0.1
    return q / q.sum()


def _assert_same(a, b, ctx=""):
    assert np.array_equal(a.indices, b.indices), \
        f"top-k membership differs {ctx}"
    assert np.array_equal(a.distances, b.distances), \
        f"distances differ {ctx} (bit-exact contract broken)"


def _vecs(rng, v, w=4):
    vecs = torch.as_tensor(rng.standard_normal((v, w)).astype(np.float32))
    return vecs, (vecs * vecs).sum(-1)


def _rows(ids, vecs, vecs_sq):
    return _cdist_rows(torch.as_tensor(np.asarray(ids, np.int64)), vecs,
                       vecs_sq)


# -------------------------------------------------------------- unit level
def test_kcache_rejects_zero_slots(index):
    with pytest.raises(ValueError):
        KCache(index.vecs, index.vecs_sq, 0)


def test_kernel_impl_refuses_cache(index):
    with pytest.raises(ValueError, match="sparse"):
        WmdEngine(index, lam=LAM, impl="kernel", kcache_slots=8)
    eng = WmdEngine(index, lam=LAM, impl="kernel")
    # an enable-by-default caller must find a quiet no-op here
    assert eng.enable_kcache(8) is False
    assert eng.kcache_stats() is None


def test_rows_match_direct_cdist_and_lru_evicts_oldest(rng):
    vecs, vecs_sq = _vecs(rng, 24)
    cache = KCache(vecs, vecs_sq, slots=4)

    ids = np.asarray([3, 7, 11])
    assert cache.lookup(ids) == 0
    got = cache.rows(ids)
    assert torch.equal(got, _rows(ids, vecs, vecs_sq))
    assert cache.stats()["used"] == 3 and cache.inserts == 3

    # fill the last slot, then miss twice: the two least recently used
    # words (3 and 7 were touched before 20) are the victims
    cache.rows(np.asarray([20]))
    assert cache.stats()["used"] == 4
    cache.rows(np.asarray([1, 2]))
    assert cache.evictions == 2
    assert set(cache._slot_of) == {11, 20, 1, 2}
    # an evicted word recomputes bit for bit on re-entry
    assert torch.equal(cache.rows(np.asarray([3])), _rows([3], vecs,
                                                          vecs_sq))
    st_ = cache.stats()
    assert st_["hits"] == 0 and st_["misses"] == 3 and st_["lookups"] == 1


def test_rows_match_reference_within_tolerance(rng):
    """The port's rows against the reference's ``_cdist_rows`` on the same
    table, in squared distance (the GEMMs sum in other orders)."""
    vecs, vecs_sq = _vecs(rng, 300, w=32)
    ids = np.arange(0, 300, 7)
    got = _rows(ids, vecs, vecs_sq).numpy()
    want = np.asarray(ref_cdist_rows(jnp.asarray(ids.astype(np.int32)),
                                     jnp.asarray(vecs.numpy()),
                                     jnp.asarray(vecs_sq.numpy())))
    scale = vecs_sq.numpy()[ids][:, None] + vecs_sq.numpy()[None, :]
    np.testing.assert_array_less(np.abs(got ** 2 - want ** 2),
                                 ROW_SQ_RTOL * scale + 1e-30)


def test_rows_do_not_depend_on_their_panel(rng):
    """A word's row is the same bits whichever call and panel position it
    comes from: alone, among KQ_PANEL + 5 others (two panels), and from
    the stacked chunk path; bf16 operands too."""
    vecs, vecs_sq = _vecs(rng, 200, w=32)
    many = rng.permutation(200)[:KQ_PANEL + 5]
    for gemm in ("fp32", "bf16"):
        batch = cdist_rows(vecs[torch.as_tensor(many)], vecs, vecs_sq, gemm)
        for j in (0, 17, KQ_PANEL + 2):
            one = cdist_rows(vecs[torch.as_tensor(many[j:j + 1])], vecs,
                             vecs_sq, gemm)
            assert torch.equal(one[0], batch[j])
        sup = torch.as_tensor(many[:24].reshape(3, 8))
        _, mq = _compute_kq(sup, torch.ones((3, 8)), vecs, vecs_sq, LAM,
                            gemm=gemm, with_m=True)
        assert torch.equal(mq.transpose(1, 2).reshape(24, -1), batch[:24])


def test_warm_fills_free_slots_only(rng):
    vecs, vecs_sq = _vecs(rng, 16)
    cache = KCache(vecs, vecs_sq, slots=4)
    cache.rows(np.asarray([0, 1, 2]))          # 3 resident, 1 free

    sup = np.asarray([[5, 6, 7]])              # fallback chunk, 3 cold
    mq = _rows(sup[0], vecs, vecs_sq).T[None]  # (1, V, 3)
    cache.warm(sup, mq)
    # warming never evicts: only the single free slot was filled
    assert cache.evictions == 0
    assert cache.stats()["used"] == 4
    assert 5 in cache._slot_of
    assert torch.equal(cache.rows(np.asarray([5])), _rows([5], vecs,
                                                          vecs_sq))


def test_rebind_drops_entries_keeps_counters(rng):
    vecs, vecs_sq = _vecs(rng, 16)
    cache = KCache(vecs, vecs_sq, slots=8)
    cache.lookup(np.asarray([1, 2]))
    cache.rows(np.asarray([1, 2]))
    fresh = cache.rebind(vecs * 2.0, vecs_sq * 4.0)
    assert fresh.stats()["used"] == 0
    assert fresh.misses == 2 and fresh.inserts == 2
    assert fresh.vecs is not cache.vecs


# --------------------------------------------------- engine-level oracle
@settings(max_examples=6, deadline=None)
@given(prune=st.sampled_from(["rwmd", "wcd+rwmd", "ivf+wcd+rwmd"]),
       precision=st.sampled_from(["fp32", "bf16", "log", "bf16+log"]),
       slots=st.sampled_from([32, 128, 512]),
       min_hits=st.integers(min_value=1, max_value=6))
def test_cache_on_equals_cache_off(prune, precision, slots, min_hits):
    """Any prune spec, precision, capacity (some small enough to force the
    oversize fallback) and hit threshold: cache-on search and query_batch
    results are the cache-off results bit for bit, cold and warm."""
    corpus = make_corpus(vocab_size=VOCAB, embed_dim=32, n_docs=64,
                         n_queries=3, seed=7)
    index = build_index(corpus.docs, corpus.vecs, device="cpu")
    off = _engine(index, cached=False, precision=precision)
    on = _engine(index, cached=True, precision=precision, slots=slots,
                 min_hits=min_hits)
    queries = list(corpus.queries)
    for pass_ in ("cold", "warm"):
        ctx = (f"({pass_}, {prune}, {precision}, slots={slots}, "
               f"min_hits={min_hits})")
        _assert_same(off.search(queries, 5, prune=prune),
                     on.search(queries, 5, prune=prune), ctx)
        assert np.array_equal(off.query_batch(queries).numpy(),
                              on.query_batch(queries).numpy()), ctx
    assert on.kcache_stats()["lookups"] > 0


def test_eviction_pressure_keeps_exactness(index):
    """A stream whose working set exceeds the slots forces LRU evictions
    mid-stream, and every answer still equals the uncached engine's."""
    on = _engine(index, cached=True, slots=24, min_hits=1)
    off = _engine(index, cached=False)
    a = _hist(range(40, 52), seed=1)               # 12 words
    b = _hist(list(range(40, 44)) + list(range(200, 216)), seed=2)
    for step, q in enumerate([a, b, a, b]):
        _assert_same(off.search([q], 5, prune="rwmd"),
                     on.search([q], 5, prune="rwmd"), f"(step {step})")
    stats = on.kcache_stats()
    assert stats["evictions"] > 0, stats
    assert stats["hits"] > 0, stats


def test_oversize_chunk_falls_back_exactly(index):
    """More unique words than slots: the stacked GEMM serves the chunk
    (counted ``oversize``), exactly."""
    on = _engine(index, cached=True, slots=8, min_hits=1)
    off = _engine(index, cached=False)
    q = _hist(range(100, 120), seed=3)             # 20 words > 8 slots
    _assert_same(off.search([q], 5, prune="rwmd"),
                 on.search([q], 5, prune="rwmd"), "(oversize)")
    stats = on.kcache_stats()
    assert stats["oversize"] > 0 and stats["fallbacks"] > 0
    assert stats["used"] <= 8


def test_append_then_search_matches_rebuild_with_warm_cache():
    """``append_docs`` keeps the embedding table, so a warm cache survives
    the append (no rebind, hits keep landing), and the answers after it
    equal the uncached engine's on the same index (bitwise) and a rebuilt
    index's (numerically)."""
    full = make_corpus(vocab_size=VOCAB, embed_dim=32, n_docs=96,
                       n_queries=4, seed=11)
    head = PaddedDocs(idx=full.docs.idx[:64], val=full.docs.val[:64])
    tail = PaddedDocs(idx=full.docs.idx[64:], val=full.docs.val[64:])
    queries = list(full.queries)

    on = _engine(build_index(head, full.vecs, device="cpu"), cached=True,
                 min_hits=1)
    on.search(queries, 5, prune="rwmd")            # warm the cache
    cache_obj = on._kcache
    assert cache_obj.stats()["used"] > 0

    on.index = append_docs(on.index, tail)
    on.reset_kcache_stats()
    appended = on.search(queries, 5, prune="rwmd")
    assert on._kcache is cache_obj                 # no rebind on append
    assert on.kcache_stats()["hits"] > 0           # warm rows survived

    off = _engine(on.index, cached=False)
    _assert_same(off.search(queries, 5, prune="rwmd"), appended,
                 "(post-append)")
    rebuilt = _engine(build_index(full.docs, full.vecs, device="cpu"),
                      cached=False).search(queries, 5, prune="rwmd")
    for qi in range(len(queries)):
        assert set(appended.indices[qi].tolist()) == \
            set(rebuilt.indices[qi].tolist())
        np.testing.assert_allclose(appended.distances[qi],
                                   rebuilt.distances[qi], rtol=1e-5,
                                   atol=1e-6)


def test_swapped_index_rebinds_cache(small_corpus, index):
    """Another embedding table object (a rebuilt index) invalidates every
    resident row: the engine swaps in a fresh cache on its next chunk and
    stays exact."""
    on = _engine(index, cached=True, min_hits=1)
    queries = list(small_corpus.queries)
    on.search(queries, 5, prune="rwmd")
    old = on._kcache
    assert old.stats()["used"] > 0

    on.index = build_index(small_corpus.docs, small_corpus.vecs,
                           device="cpu")
    res = on.search(queries, 5, prune="rwmd")
    assert on._kcache is not old                   # rebound
    off = _engine(on.index, cached=False)
    _assert_same(off.search(queries, 5, prune="rwmd"), res, "(rebound)")


def test_zipf_queries_byte_identical():
    for s, seed in ((0.0, 5), (1.0, 0), (1.6, 5)):
        a = zipf_queries(6, VOCAB, words=10, s=s, seed=seed)
        b = ref_zipf_queries(6, VOCAB, words=10, s=s, seed=seed)
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_zipf_hit_rate_monotone_in_skew(index):
    """The reuse model: the hit rate rises with traffic skew (seeded
    streams; s=0 is uniform, the cache's worst case)."""
    rates = []
    for s in (0.0, 0.8, 1.6):
        eng = _engine(index, cached=True, slots=64, min_hits=1)
        stream = zipf_queries(24, VOCAB, words=10, s=s, seed=5)
        for i in range(0, len(stream), 4):
            eng.search(stream[i:i + 4], 5, prune="rwmd")
        rates.append(eng.kcache_stats()["hit_rate"])
    assert rates == sorted(rates), rates
    assert rates[-1] > rates[0], rates


# ------------------------------------------------- against the reference
def test_counters_and_results_match_reference(small_corpus):
    """The same Zipfian traffic through the reference's cached engine and
    the port's (the index carried across): equal counters at every step,
    equal top-k, distances within R2 (P1)."""
    ref_index = ref_build_index(small_corpus.docs, small_corpus.vecs)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "index.npz")
        save_index(ref_index, path)
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files}
    index = index_from_arrays(arrays, device="cpu")
    kw = dict(lam=LAM, n_iter=N_ITER, impl="sparse", kcache_slots=48,
              kcache_min_hits=2)
    ref_eng, eng = RefEngine(ref_index, **kw), WmdEngine(index, **kw)
    stream = zipf_queries(16, VOCAB, words=10, s=1.0, seed=3)
    for i, prune in zip(range(0, 16, 4), ("rwmd", "ivf+wcd+rwmd", "rwmd",
                                          "ivf+wcd+rwmd")):
        want = ref_eng.search(stream[i:i + 4], 5, prune=prune)
        got = eng.search(stream[i:i + 4], 5, prune=prune)
        np.testing.assert_array_equal(got.indices, want.indices)
        np.testing.assert_allclose(got.distances, want.distances, **R2)
        assert eng.kcache_stats() == ref_eng.kcache_stats()
    assert eng.kcache_stats()["evictions"] > 0
