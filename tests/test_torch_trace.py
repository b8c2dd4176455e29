"""The port's recorder (``repro_torch.trace``): off by default and inert,
nesting, threads, the bounded buffer, and the span tree the search paths
record on the host, with results and launch counts the same traced or
not."""
import sys
import threading
import time
from collections import Counter

import numpy as np
import pytest
import torch

from repro_torch import trace
from repro_torch.core import one_to_many
from repro_torch.core.index import WmdEngine, build_index
from repro_torch.core.shard_index import ShardedWmdEngine, shard_corpus
from repro_torch.data.corpus import make_corpus
from repro_torch.kernels import ops


@pytest.fixture(autouse=True)
def _off_afterwards():
    yield
    trace.disable()


@pytest.fixture(scope="module")
def corpus():
    return make_corpus(vocab_size=512, embed_dim=16, n_docs=96, n_queries=6,
                       seed=4)


@pytest.fixture(scope="module")
def engine(corpus):
    index = build_index(corpus.docs, corpus.vecs, device="cpu")
    return WmdEngine(index, lam=1.0, n_iter=10, impl="kernel")


def _traced(fn):
    trace.enable()
    try:
        out = fn()
    finally:
        trace.disable()
    return out, trace.records()


def test_off_records_nothing_and_returns_the_shared_noop():
    trace.enable()
    trace.disable()
    a, b = trace.span("a"), trace.span("b")
    assert a is b and not a
    with a as s:
        s.set(docs=3)
        trace.add("bytes", 7)
    rec = trace.records()
    assert rec.spans == () and rec.counters == {} and rec.dropped == 0


def test_nesting_gives_parents_requests_and_self_times():
    trace.enable()
    with trace.span("root") as root:
        root.set(queries=2)
        time.sleep(0.02)
        with trace.span("child"):
            time.sleep(0.03)
            with trace.span("leaf"):
                pass
        with trace.span("child"):
            pass
    with trace.span("next"):
        pass
    rec = trace.records()
    by = {s.id: s for s in rec.spans}
    names = [s.name for s in rec.spans]
    assert names == ["root", "child", "leaf", "child", "next"]
    r, c1, leaf, c2, nxt = rec.spans
    assert r.parent is None and r.request == r.id
    assert c1.parent == r.id and c2.parent == r.id and leaf.parent == c1.id
    assert {c1.request, leaf.request, c2.request} == {r.id}
    assert nxt.parent is None and nxt.request == nxt.id != r.id
    assert r.attrs == {"queries": 2}
    for s in (c1, leaf, c2):
        p = by[s.parent]
        assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    dur = {s.id: s.end_ns - s.start_ns for s in rec.spans}
    root_self = dur[r.id] - dur[c1.id] - dur[c2.id]
    assert root_self >= 20e6 and dur[c1.id] - dur[leaf.id] >= 30e6


def test_threads_keep_their_own_stacks_and_counters_add_up():
    trace.enable()
    n_threads, n_adds = 8, 500
    barrier = threading.Barrier(n_threads)
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work(i):
        with trace.span(f"root{i}"):
            barrier.wait(timeout=10)        # every root open at once
            for _ in range(n_adds):
                with trace.span(f"kid{i}"):
                    trace.add("n", 1)

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(n_threads)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(before)
    assert not any(t.is_alive() for t in threads)
    rec = trace.records()
    root = {s.name: s.id for s in rec.spans if s.name.startswith("root")}
    assert len(root) == n_threads
    for s in rec.spans:
        if s.name.startswith("kid"):
            i = s.name[3:]
            assert s.parent == root[f"root{i}"] == s.request
    assert rec.counters == {"n": n_threads * n_adds}
    assert len(rec.spans) == n_threads * (n_adds + 1)


def test_bounded_buffer_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(trace, "MAX_SPANS", 3)
    trace.enable()
    for _ in range(5):
        with trace.span("s"):
            pass
    rec = trace.records()
    assert len(rec.spans) == 3 and rec.dropped == 2


def test_enable_clears():
    trace.enable()
    with trace.span("s"):
        trace.add("c", 4)
    assert trace.records().spans
    trace.enable()
    rec = trace.records()
    assert rec.spans == () and rec.counters == {} and rec.dropped == 0


def _tree(rec):
    """(name, (children...)) of each root, children in the order begun."""
    kids = {}
    for s in rec.spans:
        kids.setdefault(s.parent, []).append(s)

    def node(s):
        return (s.name, tuple(node(k) for k in kids.get(s.id, ())))
    return [node(s) for s in kids.get(None, ())]


def _chunk(*inner):
    return ("wmd.chunk", (("wmd.stage", ()), ("wmd.kblock", ())) + inner)


def test_exhaustive_search_records_the_span_tree(engine, corpus):
    qs = list(corpus.queries)
    res, rec = _traced(lambda: engine.search(qs, 5, prune=None))
    _, chunks = engine._plan(qs)
    groups = len(engine.index.groups)
    solve = ("wmd.solve", ())
    batch = ("wmd.batch",
             (("wmd.plan", ()),)
             + (_chunk(*[solve] * groups),) * len(chunks)
             + (("wmd.collect", (("wmd.wait", ()),) * len(chunks) * groups),))
    assert _tree(rec) == [("wmd.search", (batch, ("wmd.rank", ())))]
    assert rec.spans[0].attrs == {}
    vr = [int((q > 0).sum()) for q in qs]
    chunk_spans = [s for s in rec.spans if s.name == "wmd.chunk"]
    for s, (chunk, width) in zip(chunk_spans, chunks):
        assert s.attrs == {"queries": len(chunk), "width": width,
                           "query_words": sum(vr[qi] for qi in chunk),
                           "qp": 1 << (len(chunk) - 1).bit_length()}
    solves = [s for s in rec.spans if s.name == "wmd.solve"]
    live = (engine.index.docs_host.val > 0).sum(axis=1)
    for s, grp in zip(solves, list(engine.index.groups) * len(chunks)):
        assert s.attrs == {"docs": grp.cols.size,
                           "doc_words": int(live[grp.cols].sum()),
                           "n_pad": grp.cols.size,
                           "l_g": grp.docs.idx.shape[1], "stage": "batch"}
    staged = sum((1 << (len(c) - 1).bit_length()) * w * 16
                 for c, w in chunks)        # int64 ids + 2 fp32 rows
    assert rec.counters == {"h2d_pageable_bytes": staged}


def test_rwmd_search_records_the_span_tree(engine, corpus):
    qs = list(corpus.queries)
    res, rec = _traced(lambda: engine.search(qs, 5, prune="rwmd"))
    (root,) = _tree(rec)
    assert root[0] == "wmd.search"
    kids = [k[0] for k in root[1]]
    _, chunks = engine._plan(qs)
    assert kids == ["wmd.plan"] + ["wmd.chunk"] * len(chunks)
    solve = ("wmd.subset", ()), ("wmd.solve", ()), ("wmd.wait", ())
    prune = ("wmd.prune", (("wmd.wait", ()),))
    head = (("wmd.bound", ()), prune) + solve + (prune,)
    rank = ("wmd.rank", ())
    for node in root[1][1:]:            # with and without survivors
        assert node in (_chunk(*head, rank), _chunk(*head, *solve, rank))
    solved = [s for s in rec.spans if s.name == "wmd.solve"]
    assert {s.attrs["stage"] for s in solved} <= {"seed", "survivor"}
    by = {s.id: s for s in rec.spans}
    for s in solved:
        assert by[s.parent].name == "wmd.chunk"
        assert s.attrs["n_pad"] >= s.attrs["docs"] > 0
    # every solved document's words, as the result's solved counts
    docs = sum(s.attrs["docs"] for s in solved)
    assert docs == sum(res.solved[chunk[0]] for chunk, _ in chunks)
    assert set(rec.counters) == {"h2d_pageable_bytes"}


def test_one_to_many_records_the_span_tree(corpus):
    q = corpus.queries[0]
    out, rec = _traced(lambda: one_to_many(q, corpus.docs, corpus.vecs,
                                           lam=1.0, n_iter=10,
                                           impl="kernel", device="cpu"))
    assert _tree(rec) == [("wmd.one", (("wmd.one.stage", ()),
                                       ("wmd.one.solve", ()),
                                       ("wmd.wait", ())))]
    v = int((q > 0).sum())
    # the inputs go up as they are (int32 ids widen on the device),
    # then the support's int64 ids and fp32 weights
    assert corpus.docs.idx.dtype == np.int32
    host = corpus.vecs.nbytes + corpus.docs.idx.nbytes + corpus.docs.val.nbytes
    assert rec.counters == {"h2d_pageable_bytes": host + 12 * v}


@pytest.mark.parametrize("kw", [
    {}, {"tol": 1e-3}, {"impl": "sparse", "tol": 1e-3, "warm_start": True}],
    ids=["fixed", "scoped", "scoped_warm"])
def test_pruned_search_counts_the_bytes_it_uploads(corpus, kw):
    """The pruned path's ``h2d_pageable_bytes``, by hand: each chunk's
    staged rows, each solve's subset of int64 ids (widened on the host from
    the mirror's int32) and fp32 weights, the seed distances for the
    threshold, and, where the solve is scoped per query, the survivor ids
    and the seed picks' mask."""
    eng = WmdEngine(build_index(corpus.docs, corpus.vecs, device="cpu"),
                    **{"lam": 1.0, "n_iter": 10, "impl": "kernel", **kw})
    assert eng.index.docs_host.idx.dtype == np.int32
    assert eng.index.subset(np.arange(3)).docs.idx.dtype == torch.int64
    qs = list(corpus.queries)
    _, rec = _traced(lambda: eng.search(qs, 5, prune="rwmd"))
    by = {s.id: s for s in rec.spans}
    want = 0
    for c in (s for s in rec.spans if s.name == "wmd.chunk"):
        a = c.attrs
        want += a["qp"] * a["width"] * 16       # int64 ids + 2 fp32 rows
        docs = {}
        for s in rec.spans:
            if s.name == "wmd.solve" and by[s.parent] is c:
                want += s.attrs["n_pad"] * s.attrs["l_g"] * (8 + 4)
                docs[s.attrs["stage"]] = s.attrs["docs"]
        want += a["queries"] * docs["seed"] * 4     # the threshold's input
        if eng._scoped() and "survivor" in docs:
            want += docs["survivor"] * 8
        if eng._scoped() and eng._warm():
            want += a["queries"] * docs["seed"]     # bool seed picks
    assert want > 0
    assert rec.counters == {"h2d_pageable_bytes": want}


def test_sharded_search_records_its_merge(corpus):
    sindex = shard_corpus(corpus.docs, corpus.vecs, 2, devices=["cpu"] * 2)
    eng = ShardedWmdEngine(sindex, lam=1.0, n_iter=10)
    _, rec = _traced(lambda: eng.search(list(corpus.queries), 5,
                                        prune="rwmd"))
    merges = [s for s in rec.spans if s.name == "wmd.shard.merge"]
    assert len(merges) == 1 and merges[0].end_ns > merges[0].start_ns


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
@pytest.mark.parametrize("path", ["exhaustive", "rwmd", "one_to_many"])
def test_results_and_launches_are_the_same_traced_or_not(corpus, path,
                                                          device):
    """Bit for bit, and the hand-written kernels' launch counts (which
    only the card counts) equal."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    qs = list(corpus.queries)
    eng = WmdEngine(build_index(corpus.docs, corpus.vecs, device=device),
                    lam=1.0, n_iter=10, impl="kernel")
    call = {
        "exhaustive": lambda: eng.search(qs, 5, prune=None),
        "rwmd": lambda: eng.search(qs, 5, prune="rwmd"),
        "one_to_many": lambda: (one_to_many(
            qs[1], corpus.docs, corpus.vecs, lam=1.0, n_iter=10,
            impl="kernel", device=device).cpu(),),
    }[path]

    def run():
        ops.reset_launches()
        out = call()
        return [np.asarray(a) for a in out], Counter(ops.launches())

    plain, plain_n = run()
    (traced, traced_n), rec = _traced(run)
    assert rec.spans
    assert traced_n == plain_n
    assert device == "cpu" or sum(plain_n.values()) > 0
    for a, b in zip(plain, traced):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
