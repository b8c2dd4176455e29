"""The near-duplicate configuration (``dedup_wmd``, drawn by
``bench/corpora/dedup.py``) and its cell ``dedup_wmd.cascade_b16``: the
corpus law, the cell end to end on the host (answers equal to the
exhaustive search's; planted faults read not correct), the cascade's
readers on planted records, and ``solve_roofline``'s count of the
cascade's solves."""
from __future__ import annotations

import json
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bench_helpers import ROOT, host_run, tiny_config
from bench.reference.wmd import wmd_one_to_all
from bench.wmdbench import cell as cells, roofline, spans
from bench.wmdbench.profile import Trace
from bench.wmdbench.window import Call

CELL = "tiny_dedup_wmd.cascade_b16"
READERS = ("idle_in_cascade_ms_per_query", "idle_in_rwmd_vocab_ms_per_query",
           "rwmd_subset_roofline")


def _module():
    cfg = json.loads((ROOT / "bench" / "configs" / "dedup_wmd.json")
                     .read_text())
    return cells.corpus_module(cfg)


@pytest.fixture(scope="module")
def tiny():
    return tiny_config("dedup_wmd")


@pytest.fixture(scope="module")
def drawn(tiny):
    return _module().draw(tiny, 2**31 + 9, "cpu")


def test_config_is_the_papers_widths():
    cfg = json.loads((ROOT / "bench" / "configs" / "dedup_wmd.json")
                     .read_text())
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in spec["configs"] if c["name"] == "dedup_wmd")
    assert entry["reduced"] == [] and cfg["corpus"] == "dedup"
    assert (cfg["vocab_size"], cfg["embed_dim"], cfg["n_docs"],
            cfg["variants"]) == (100_000, 300, 4992, 16)
    assert (cfg["lam"], cfg["n_iter"], cfg["tf32"]) == (10.0, 15, False)
    paper = json.loads((ROOT / "bench" / "configs" / "paper_wmd.json")
                       .read_text())
    eng = dict(cfg["engine"])
    assert eng.pop("cascade_bound") == "admissible"
    assert eng == paper["engine"]


@pytest.mark.parametrize("seed", [3, 2**31 + 9])
def test_make_is_deterministic_and_tiny_draws_in_seconds(tiny, seed):
    mod = _module()
    t = time.perf_counter()
    a = mod.make(tiny, seed, "cpu")
    assert time.perf_counter() - t < 10.0
    b = mod.make(tiny, seed, "cpu")
    other = mod.make(tiny, seed + 1, "cpu")
    assert torch.equal(a.vecs, b.vecs)
    for part in ("docs", "pool"):
        for x, y in zip(getattr(a, part), getattr(b, part)):
            assert x.dtype == y.dtype and np.array_equal(x, y), part
    assert not np.array_equal(a.pool.ids, other.pool.ids)
    assert np.array_equal(a.idx, b.idx) and np.array_equal(a.val, b.val)
    assert a.docs.n == tiny["n_docs"] and a.pool.n == 256


def test_bags_hold_distinct_ids_and_frequencies(drawn):
    corpus, _, _ = drawn
    for bags in (corpus.docs, corpus.pool):
        sizes = bags.sizes()
        assert (sizes >= 1).all()
        row = np.repeat(np.arange(bags.n), sizes)
        key = row * 10**6 + bags.ids
        assert np.unique(key).size == key.size
        sums = np.add.reduceat(bags.w.astype(np.float64), bags.ptr[:-1])
        np.testing.assert_allclose(sums, 1.0, rtol=1e-5)
        assert (bags.w > 0).all()


def test_variants_are_their_bases_with_one_word_swapped(drawn, tiny):
    """Each document is one of 16 variants of its base, each base's 16
    laid out in a shuffled order; a variant shares all but at most one
    of its base's words; the pool walks every base once per 6 queries."""
    corpus, doc_base, pool_base = drawn
    n_base = tiny["n_docs"] // 16
    assert np.array_equal(np.bincount(doc_base, minlength=n_base),
                          np.full(n_base, 16))
    assert not np.array_equal(doc_base, np.sort(doc_base))
    for block in pool_base[:len(pool_base) // n_base * n_base].reshape(
            -1, n_base):
        assert np.array_equal(np.sort(block), np.arange(n_base))
    docs = corpus.docs

    def words(bags, i):
        return set(bags.ids[bags.ptr[i]:bags.ptr[i + 1]].tolist())

    for b in range(n_base):
        mine = [words(docs, i) for i in np.nonzero(doc_base == b)[0]]
        # the base's words: those most of its variants hold
        held = [w for w in set.union(*mine)
                if sum(w in m for m in mine) > len(mine) // 2]
        assert all(len(m - set(held)) <= 1 and len(set(held) - m) <= 1
                   for m in mine)


def test_pool_queries_find_their_own_variants(drawn, tiny):
    """Every query's reference top 10 lies among its own base's 16
    variants (the first 24 pool queries, 4 walks of the bases)."""
    corpus, doc_base, pool_base = drawn
    pool = corpus.pool
    for p in range(24):
        d = wmd_one_to_all(pool.ids[pool.ptr[p]:pool.ptr[p + 1]],
                           pool.w[pool.ptr[p]:pool.ptr[p + 1]], corpus.vecs,
                           corpus.idx, corpus.val, tiny["lam"],
                           tiny["n_iter"])
        top = np.argsort(d, kind="stable")[:10]
        assert (doc_base[top] == pool_base[p]).all(), p


# every call of the run also searches exhaustively; each answer that
# differs from the exhaustive one is written down
SAME_AS_EXHAUSTIVE = """
import json
import numpy as np
from repro_torch.core import index
_search = index.WmdEngine.search
seen = {"calls": 0, "differ": []}
def search(self, queries, k, prune="rwmd", **kw):
    res = _search(self, queries, k, prune=prune, **kw)
    ex = _search(self, queries, k, prune=None)
    seen["calls"] += 1
    for i in range(len(queries)):
        if not np.array_equal(np.sort(res.indices[i]), np.sort(ex.indices[i])):
            seen["differ"].append(i)
    seen["prune"] = prune
    json.dump(seen, open("seen_dedup.json", "w"))
    return res
index.WmdEngine.search = search
"""


def test_tiny_cell_is_correct_and_exact(tree):
    r = host_run(tree, CELL, seed=2**31 + 21, seconds=0.5,
                 prelude=SAME_AS_EXHAUSTIVE)
    assert r["correct"] is True and r["failed"] == 0, r["checks"]
    seen = json.loads((tree / "seen_dedup.json").read_text())
    assert seen["prune"] == "ivf+wcd+rwmd" and seen["calls"] > 2
    assert seen["differ"] == []


PATCH = """
import numpy as np
from repro_torch.core import index
_search = index.WmdEngine.search
def search(self, queries, k, *a, **kw):
    res = _search(self, queries, k, *a, **kw)
    ids, dist = res.indices.copy(), res.distances.copy()
    {body}
    return index.SearchResult(ids, dist, res.solved)
index.WmdEngine.search = search
"""

FAULTS = {
    # the nearest near-duplicate left out, the 11th put at the end
    "dropped_near_duplicate": PATCH.format(body="""
    full = _search(self, queries, k + 1, prune=None)
    ids, dist = full.indices[:, 1:].copy(), full.distances[:, 1:].copy()"""),
    "wrong_id": PATCH.format(
        body="ids[:, 0] = [np.setdiff1d(np.arange(self.index.n_docs), "
             "row)[-1] for row in ids]"),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_is_not_correct(tree, fault):
    r = host_run(tree, CELL, seed=2**31 + 21, seconds=0.3,
                 prelude=FAULTS[fault])
    assert r["correct"] is False
    gap = r["checks"]["topk_gap"]
    assert gap["value"] is None or gap["value"] > gap["limit"], r["checks"]


def _span(i, name, a, b, parent=None, **attrs):
    from repro_torch.trace import Span
    return Span(name, int(a * 1e3), int(b * 1e3), parent, 0, i, attrs)


def _run(gaps, device=()):
    """A run over a window of 0..1000 us (profiler time = perf_counter
    time + 500 us) whose device idles in ``gaps`` (us) and runs
    ``device`` events besides, one call answering four queries."""
    busy, t = list(device), 0.0
    for s, e in gaps:
        if s > t:
            busy.append(("k", 500 + t, 500 + s))
        t = e
    if t < 1000:
        busy.append(("k", 500 + t, 1500))
    tr = Trace(device=busy, host=[], runtime={}, spans={},
               window=(500.0, 1500.0),
               calls=[Call(t0=0.0, t1=1e-3, positions=tuple(range(4)),
                           answers=object(), error=None)])
    return SimpleNamespace(trace=tr, cell=SimpleNamespace(
        config={"embed_dim": 300}))


def _read(name, run, rec, monkeypatch):
    monkeypatch.setattr(spans, "records", lambda: rec)
    return cells.metric_reader(name).read(run)


def test_readers_on_planted_records(monkeypatch):
    from repro_torch.trace import Records
    # search 0..1000: probe 0..100, seed 100..300 (a wait 200..250 in
    # it), first 300..400, keep 400..700 with an RWMD stage 500..650 and
    # its vocabulary staging 500..560, rank 900..950; the device idles
    # 0..50, 150..260, 320..340, 450..470, 520..540 and 600..610 (us)
    s = [_span(0, "wmd.search", 0, 1000),
         _span(1, "wmd.cascade.probe", 0, 100, 0),
         _span(2, "wmd.cascade.seed", 100, 300, 0),
         _span(3, "wmd.wait", 200, 250, 2),
         _span(4, "wmd.cascade.first", 300, 400, 0),
         _span(5, "wmd.cascade.keep", 400, 700, 0),
         _span(6, "wmd.cascade.rwmd", 500, 650, 5, rows=300, vc=2000,
               queries=16, docs_in=100, docs_out=40),
         _span(7, "wmd.cascade.vocab", 500, 560, 6, docs=100, vc=2000),
         _span(8, "wmd.rank", 900, 950, 0)]
    gaps = [(0, 50), (150, 260), (320, 340), (450, 470), (520, 540),
            (600, 610)]
    k2s = [("void rwmd_min_cdist_subset_kernel<4>", 560.0 + 500, 600.0 + 500),
           ("void rwmd_min_cdist_stacked_kernel<128>", 610.0 + 500,
            620.0 + 500)]
    run = _run(gaps, device=k2s)
    rec = Records(tuple(s), {}, 0)
    # probe 50, seed 50 + 10 (its wait's 50 us are the wait's), first 20,
    # keep 20: 150 us over 4 queries
    assert _read("idle_in_cascade_ms_per_query", run, rec,
                 monkeypatch) == pytest.approx(150 / 4e3)
    assert _read("idle_in_rwmd_vocab_ms_per_query", run, rec,
                 monkeypatch) == pytest.approx(20 / 4e3)
    mod = cells.metric_reader("rwmd_subset_roofline")
    want = mod.work(300, 2000, 16, 300)
    assert want == roofline.Work(300 * 2000 * 605.0,
                                 4.0 * (2000 * 300 + 300 * 300)
                                 + 4.0 * 16 * 2000)
    got = _read("rwmd_subset_roofline", run, rec, monkeypatch)
    assert got == pytest.approx(100.0 * want.seconds() / 50e-6)
    assert 0 < got < 100


def test_roofline_needs_the_spans_and_the_kernels(monkeypatch):
    from repro_torch.trace import Records
    rec = Records((_span(0, "wmd.cascade.rwmd", 0, 10, rows=30, vc=200,
                         queries=4),), {}, 0)
    assert _read("rwmd_subset_roofline", _run([]), rec, monkeypatch) is None
    k2s = [("rwmd_min_cdist_subset_kernel", 600.0, 610.0)]
    no_rows = Records((_span(0, "wmd.cascade.rwmd", 0, 10, vc=200),), {}, 0)
    assert _read("rwmd_subset_roofline", _run([], k2s), no_rows,
                 monkeypatch) is None


def test_a_program_without_the_recorder_reads_nothing(monkeypatch):
    import builtins
    real = builtins.__import__

    def no_trace(name, globals=None, locals=None, fromlist=(), level=0):
        if name == "repro_torch" and fromlist and "trace" in fromlist:
            raise ImportError("no recorder")
        return real(name, globals, locals, fromlist, level)
    monkeypatch.setattr(builtins, "__import__", no_trace)
    spans.enable()
    assert spans.records() is None
    run = _run([(0, 100)], [("rwmd_min_cdist_subset_kernel", 700.0, 710.0)])
    for name in READERS:
        assert cells.metric_reader(name).read(run) is None


def test_solve_roofline_counts_the_cascades_solves():
    """``solve_roofline``'s wrappers log each cascade chunk's seed and
    survivor solves: per chunk, the documents they met are each query's
    ``SearchResult.solved``, and there are as many as ``wmd.solve``
    spans."""
    from repro_torch import trace
    from bench.entries.search import System
    cfg = tiny_config("dedup_wmd")
    mix = json.loads((ROOT / "bench" / "traffic" / "cascade_b16.json")
                     .read_text())
    system = System(cells.make_corpus(cfg, 5, "cpu"), cfg, mix, "cpu")
    cells.metric_reader("solve_roofline").instrument(system)
    trace.enable()
    try:
        _, _, solved = system.call(system.rows(range(16)))
    finally:
        trace.disable()
    (entries,) = system.solve_log
    stages = [s.attrs["stage"] for s in trace.records().spans
              if s.name == "wmd.solve"]
    assert len(stages) == len(entries)
    assert {"seed", "survivor"} <= set(stages)
    met = {}
    for key, v, cols in entries:
        met.setdefault(key, [len(v), set()])[1].update(cols.tolist())
    assert sum(n * len(docs) for n, docs in met.values()) == solved.sum()
    assert {len(docs) for _, docs in met.values()} == set(solved.tolist())
    assert 0 < solved.max() < cfg["n_docs"]
