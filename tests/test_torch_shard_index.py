"""The port's sharded corpus engine (``repro_torch.core.shard_index``) on
the CPU, in one process: mirrors of the 7 tests of
``tests/test_shard_index.py``, where the reference runs 2-, 4- and
8-device meshes in subprocesses under an XLA flag and the port runs the
same shard counts on repeated ``"cpu"`` mesh positions; plus the kernel
layer's launch counters under threads.

Tolerances: one shard is bit for bit the single engine. More shards stage
their own query chunks against their own docs, so the CPU GEMMs behind the
K block may sum in another order (ROADMAP queue 3, P1): distances are held
as the reference's own invariance script holds them (sorted per query,
rtol 2e-4) and ids position by position except inside runs of near-tied
distances, which hold as sets.
"""
import threading
import time

import numpy as np
import pytest
import torch

from repro.core import bin_pack_clusters as ref_bin_pack
from repro_torch.core.distributed import sinkhorn_wmd_sparse_distributed
from repro_torch.core.index import WmdEngine, build_index
from repro_torch.core.shard_index import (ShardedWmdEngine,
                                          append_docs_sharded,
                                          bin_pack_clusters, merge_topk,
                                          shard_corpus)
from repro_torch.core.sinkhorn import LamUnderflowError, select_support
from repro_torch.core.sparse import PaddedDocs
from repro_torch.data.corpus import make_corpus
from repro_torch.kernels import ops
from repro_torch.runtime.sharding import count_collectives, make_mesh

CPU = ["cpu"]
KW = dict(lam=8.0, n_iter=25)
PRUNE = "ivf+wcd+rwmd"
INVARIANCE_RTOL = 2e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors: one intra-op thread runs them faster, and far faster
    when several test workers share the host. Restored afterwards."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def corpus96():
    return make_corpus(vocab_size=512, embed_dim=16, n_docs=96, n_queries=3,
                       seed=2)


@pytest.fixture(scope="module")
def single96(corpus96):
    c = corpus96
    index = build_index(c.docs, c.vecs, n_clusters=12, device="cpu")
    return WmdEngine(index, **KW).search(list(c.queries), 5, prune=PRUNE)


def _tie_equal(got, want, rtol=INVARIANCE_RTOL):
    for qi in range(want.indices.shape[0]):
        np.testing.assert_allclose(np.sort(got.distances[qi]),
                                   np.sort(want.distances[qi]), rtol=rtol,
                                   equal_nan=True, err_msg=f"query {qi}")
        d, g, w = want.distances[qi], got.indices[qi], want.indices[qi]
        start = 0
        for j in range(1, len(d) + 1):
            if j == len(d) or abs(d[j] - d[j - 1]) > 2 * rtol * abs(d[j]):
                assert set(g[start:j]) == set(w[start:j]), (qi, g, w)
                start = j


# ---------------------------------------------------------------- quick ----
def test_bin_pack_clusters_covers_and_balances():
    rng = np.random.default_rng(0)
    sizes = rng.integers(1, 200, size=37)
    for n_shards in (1, 2, 4, 7):
        shard_of = bin_pack_clusters(sizes, n_shards)
        assert shard_of.shape == (37,)
        assert shard_of.min() >= 0 and shard_of.max() < n_shards
        loads = np.bincount(shard_of, weights=sizes, minlength=n_shards)
        # LPT greedy bound: no shard exceeds the ideal by a whole cluster
        assert loads.max() <= sizes.sum() / n_shards + sizes.max()
        # the same deterministic packing as the reference's
        assert np.array_equal(shard_of, ref_bin_pack(sizes, n_shards))


def test_single_shard_bitcompat_and_id_partition():
    c = make_corpus(vocab_size=256, embed_dim=16, n_docs=48, n_queries=2,
                    seed=3)
    index = build_index(c.docs, c.vecs, n_clusters=6, device="cpu")
    ref = WmdEngine(index, lam=8.0, n_iter=25).search(
        list(c.queries), 5, prune=PRUNE)

    sindex = shard_corpus(c.docs, c.vecs, 1, n_clusters=6, devices=CPU)
    # global ids partition [0, N) and owner agrees with the partition
    ids = np.sort(np.concatenate(sindex.global_ids))
    assert np.array_equal(ids, np.arange(48))
    for s, gid in enumerate(sindex.global_ids):
        assert np.all(sindex.owner[gid] == s)

    res = ShardedWmdEngine(sindex, lam=8.0, n_iter=25).search(
        list(c.queries), 5, prune=PRUNE)
    # one shard is bit-compatible with the single-device engine
    assert np.array_equal(ref.indices, res.indices)
    np.testing.assert_array_equal(ref.distances, res.distances)
    assert np.array_equal(ref.solved, res.solved)


def test_merge_is_exactly_one_all_gather():
    c = make_corpus(vocab_size=256, embed_dim=16, n_docs=32, n_queries=1,
                    seed=4)
    engine = ShardedWmdEngine(
        shard_corpus(c.docs, c.vecs, 1, n_clusters=4, devices=CPU),
        lam=8.0, n_iter=10)
    k = 3
    per_shard = {0: (np.array([[0, 1, 2], [3, -1, -1]], np.int32),
                     np.array([[0.5, 0.7, 0.9], [0.4, np.nan, np.nan]],
                              np.float32))}
    colls = count_collectives(engine._merge_topk, per_shard, 2, k)
    assert colls == {"all_gather": 1}
    # and the whole search: still one collective, the merge's
    colls = count_collectives(engine.search, list(c.queries), k)
    assert colls == {"all_gather": 1}


def test_merge_breaks_ties_toward_the_lowest_shard_major_index():
    """lax.top_k's lowest-index tie-break: equal distances come out in
    shard-major order (shard 0 first), padding last."""
    k = 3
    inf = float("inf")
    lane0 = torch.tensor([[1.0, 2.0, inf, 10.0, 11.0, -1.0]])
    lane1 = torch.tensor([[1.0, 2.0, 2.0, 20.0, 21.0, 22.0]])
    dist, ids = merge_topk([lane0, lane1], k, "cpu")
    assert dist.tolist() == [[1.0, 1.0, 2.0]]
    assert ids.tolist() == [[10.0, 20.0, 11.0]]


def test_underflow_report_names_shard_and_external_ids():
    c = make_corpus(vocab_size=256, embed_dim=16, n_docs=16, n_queries=1,
                    seed=5)
    r, vs, _ = select_support(c.queries[0], torch.as_tensor(c.vecs))
    mesh = make_mesh((1, 1), ("data", "model"), CPU)
    ext = np.arange(16, dtype=np.int64) + 7000
    with pytest.raises(LamUnderflowError) as ei:
        sinkhorn_wmd_sparse_distributed(r, vs, c.vecs, c.docs, 500.0, 10,
                                        mesh, doc_ids=ext)
    msg = str(ei.value)
    assert "owning shard(s)" in msg
    assert "external doc ids" in msg
    assert "70" in msg          # quoted ids are the external ones


# --------------------------------------------------------- multi-shard ----
def test_shard_invariance_multishard(corpus96, single96):
    """1, 2 and 4 shards equal the single engine at nprobe=None; recall is
    monotone in nprobe per shard count and 1 at nprobe=None; append then
    search equals rebuild then search."""
    c = corpus96
    queries, k = list(c.queries), 5
    engines = {}
    for s in (1, 2, 4):
        sindex = shard_corpus(c.docs, c.vecs, s, n_clusters=12, devices=CPU)
        assert sindex.n_shards == s and sum(sindex.docs_per_shard) == 96
        engines[s] = ShardedWmdEngine(sindex, **KW)
        res = engines[s].search(queries, k, prune=PRUNE)
        assert engines[s].last_coverage.full
        _tie_equal(res, single96)
        if s == 1:
            assert np.array_equal(single96.indices, res.indices)
            assert np.array_equal(single96.distances, res.distances)

    def recall(res):
        return np.mean([len(set(single96.indices[qi])
                            & set(res.indices[qi])) / k
                        for qi in range(len(queries))])

    for s in (2, 4):
        prev = -1.0
        for nprobe in (1, 2, 4, None):
            r = recall(engines[s].search(queries, k, prune=PRUNE,
                                         nprobe=nprobe))
            assert r >= prev - 1e-12, (s, nprobe, r, prev)
            prev = r
        assert prev == 1.0, (s, prev)   # nprobe=None is exact

    head = PaddedDocs(c.docs.idx[:64], c.docs.val[:64])
    tail = PaddedDocs(c.docs.idx[64:], c.docs.val[64:])
    sindex = shard_corpus(head, c.vecs, 4, n_clusters=12, devices=CPU)
    sindex = append_docs_sharded(sindex, tail)
    eng = ShardedWmdEngine(sindex, **KW)
    assert eng.n_docs == 96
    ids = np.sort(np.concatenate(sindex.global_ids))
    assert np.array_equal(ids, np.arange(96))
    _tie_equal(eng.search(queries, k, prune=PRUNE), single96)


def test_shard_collective_structure_multishard(corpus96):
    """On the serving path exactly one all_gather per merge; the
    distributed sparse solve's fixed loop runs no collective and its
    adaptive loop only pmax; a poisoning lam names the owning shard."""
    c = corpus96
    engine = ShardedWmdEngine(
        shard_corpus(c.docs, c.vecs, 4, n_clusters=12, devices=CPU),
        lam=8.0, n_iter=10)
    k = 5
    colls = count_collectives(engine.search, list(c.queries), k,
                              prune=PRUNE)
    assert colls == {"all_gather": 1}, colls

    r, vs, _ = select_support(c.queries[0], torch.as_tensor(c.vecs))
    mesh = make_mesh((8,), ("data",), CPU)
    fixed = count_collectives(
        sinkhorn_wmd_sparse_distributed, r, vs, c.vecs, c.docs, 8.0, 10,
        mesh, vshard_precompute=False, check_underflow=False)
    assert fixed == {}, fixed
    adaptive = count_collectives(
        sinkhorn_wmd_sparse_distributed, r, vs, c.vecs, c.docs, 8.0, 10,
        mesh, vshard_precompute=False, check_underflow=False, tol=1e-3)
    assert adaptive and set(adaptive) == {"pmax"}, adaptive

    hot = ShardedWmdEngine(
        shard_corpus(c.docs, c.vecs, 2, n_clusters=12, devices=CPU),
        lam=500.0, n_iter=10)
    with pytest.raises(LamUnderflowError, match="owning shard"):
        hot.search(list(c.queries), 3, prune=None)


def test_shard_fault_partials_and_recovery_multishard(corpus96, tmp_path):
    """Two shards: a short shard lane (k above a shard's doc count), rows
    with no survivor at nprobe=1, a raw shard exception and a hang as
    partial results with honest coverage, and a bit-exact restore. The
    hang waits on an event, not on a sleep, so no timing race decides
    the outcome."""
    c = corpus96
    queries, k = list(c.queries), 5
    engine = ShardedWmdEngine(
        shard_corpus(c.docs, c.vecs, 2, n_clusters=12, devices=CPU),
        shard_timeout_s=30.0, shard_retries=0, fail_threshold=3,
        snapshot_dir=str(tmp_path), **KW)
    baseline = engine.search(queries, k, prune=PRUNE)
    assert engine.last_coverage.full
    engine.snapshot()

    big_k = min(engine.docs_per_shard) + 3
    ref = WmdEngine(build_index(c.docs, c.vecs, n_clusters=12,
                                device="cpu"), **KW).search(
        queries, big_k, prune=PRUNE)
    got = engine.search(queries, big_k, prune=PRUNE)
    for qi in range(len(queries)):
        np.testing.assert_allclose(np.sort(ref.distances[qi]),
                                   np.sort(got.distances[qi]),
                                   rtol=INVARIANCE_RTOL, equal_nan=True)

    r1 = engine.search(queries, k, prune=PRUNE, nprobe=1)
    assert r1.indices.shape == (len(queries), k)
    assert r1.indices.max() < engine.n_docs
    assert np.all(np.isnan(r1.distances[r1.indices < 0]))

    orig = engine.engines[1].search

    def boom(*a, **kw):
        raise ValueError("injected shard death")

    engine.engines[1].search = boom
    res = engine.search(queries, k, prune=PRUNE)
    cov = engine.last_coverage
    assert cov.missing_shards == (1,), cov
    assert cov.fraction == pytest.approx(engine.docs_per_shard[0]
                                         / engine.n_docs)
    assert "ValueError" in cov.reasons[1], cov.reasons
    shard0 = set(engine.sindex.global_ids[0].tolist())
    assert set(res.indices[res.indices >= 0].tolist()) <= shard0

    release, finished = threading.Event(), threading.Event()

    def hang(*a, **kw):
        try:
            release.wait(60.0)
            return orig(*a, **kw)
        finally:
            finished.set()

    engine.engines[1].search = hang
    engine.shard_timeout_s = 0.2
    engine.search(queries, k, prune=PRUNE)
    assert engine.last_coverage.reasons.get(1) == "timeout", \
        engine.last_coverage
    release.set()
    assert finished.wait(60.0)          # the hung shard's thread is done
    engine.shard_timeout_s = 30.0
    engine.restore_shard(1)             # the rebuilt engine drops the patch
    res = engine.search(queries, k, prune=PRUNE)
    assert engine.last_coverage.full
    assert np.array_equal(baseline.indices, res.indices)
    assert np.array_equal(baseline.distances, res.distances)


# ----------------------------------------------- the kernel layer, threads
def test_launch_counters_exact_under_threads():
    """Eight threads adding to one wrapper's counter lose no count (the
    sharded fan-out launches from pool threads)."""
    fn = ops.rwmd_min_cdist_subset
    before = fn.launches
    n, per = 8, 2000
    start = threading.Barrier(n)

    def work():
        start.wait()
        for _ in range(per):
            ops._count(fn)

    threads = [threading.Thread(target=work) for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert fn.launches == before + n * per
    ops.reset_launches()
    assert set(ops.launches().values()) == {0}


def test_fan_out_runs_shards_on_pool_threads(corpus96):
    """Each shard's search runs on the engine's own pool, one thread per
    shard, so shards on different cards can overlap."""
    c = corpus96
    engine = ShardedWmdEngine(
        shard_corpus(c.docs, c.vecs, 2, n_clusters=12, devices=CPU), **KW)
    seen = {}
    for si, e in enumerate(engine.engines):
        orig = e.search

        def spy(*a, _si=si, _orig=orig, **kw):
            seen[_si] = threading.current_thread().name
            time.sleep(0.01)
            return _orig(*a, **kw)

        e.search = spy
    engine.search(list(c.queries), 5, prune=PRUNE)
    assert sorted(seen) == [0, 1]
    assert all(name.startswith("wmd-shard") for name in seen.values())
