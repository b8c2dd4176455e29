"""The frozen generator: the published sizes, 20NEWS's 72 unique words a
document, and the same arrays from the same seed."""
from __future__ import annotations

import json

import numpy as np
import pytest

from bench_helpers import ROOT
from bench.traffic import generate

CFG = {n: json.loads((ROOT / "bench" / "configs" / f"{n}.json").read_text())
       for n in ("paper_wmd", "news20_knn")}
# the source's mean of unique words a document, and the margin a seed's
# mean keeps from it (the mean of 11293 documents whose sd is ~64 words
# moves by ~0.6 from seed to seed)
NEWS20_MEAN_UNIQUE, MARGIN = 72.0, 3.0


# queries a window of news20_knn.rwmd_b64 answers (~650 a second for 51 s,
# PERF.md): the pool holds more, so that none repeats inside a window
NEWS20_WINDOW_QUERIES = 34_000


def cpu_gen(seed, stream=generate.STREAM_DOCS):
    return generate.generator(seed, stream, "cpu")


def test_news20_sizes_as_published():
    c = CFG["news20_knn"]
    assert (c["n_docs"], c["n_test"]) == (11293, 7528)
    assert (c["vocab_size"], c["embed_dim"]) == (29671, 300)
    assert c["query_pool"]["words"] == c["doc_words"]
    assert c["query_pool"]["size"] > NEWS20_WINDOW_QUERIES


def test_paper_sizes_as_published():
    c = CFG["paper_wmd"]
    assert (c["vocab_size"], c["embed_dim"], c["n_docs"]) == (100000, 300,
                                                             5000)
    assert (c["lam"], c["n_iter"]) == (10.0, 15)
    # documents of ~35 distinct words (mean of the law), queries between
    # the paper's two profiled queries of 19 and 43 words
    d, q = c["doc_words"], c["query_pool"]["words"]
    assert d["count"] == q["count"] == "unique"
    assert (d["low"] + d["high"]) / 2 == 35
    assert (q["low"], q["high"]) == (19, 43)


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 5])
def test_news20_mean_unique_words(seed):
    c = CFG["news20_knn"]
    spec = c["doc_words"]
    bags = generate.draw_bags(cpu_gen(seed), c["n_docs"], c["vocab_size"],
                              spec, c["zipf_a"])
    sizes = bags.sizes()
    assert abs(sizes.mean() - NEWS20_MEAN_UNIQUE) < MARGIN
    assert sizes.max() <= spec["max_unique"]
    assert sizes.max() > 4 * NEWS20_MEAN_UNIQUE     # a long tail


@pytest.mark.parametrize("seed", [0, 2**31 + 5])
def test_paper_bags_hold_their_number_of_distinct_words(seed):
    c = CFG["paper_wmd"]
    spec = c["doc_words"]
    bags = generate.draw_bags(cpu_gen(seed), 2000, c["vocab_size"], spec,
                              c["zipf_a"])
    sizes = bags.sizes()
    want = generate.draw_lengths(cpu_gen(seed), 2000, spec).numpy()
    assert np.array_equal(sizes, want)          # the law's own numbers
    assert (sizes.min(), sizes.max()) == (spec["low"], spec["high"])
    assert sizes.mean() == pytest.approx(35.0, abs=0.05)
    for i in range(0, bags.n, 97):              # counts from the draws
        w = bags.w[bags.ptr[i]:bags.ptr[i + 1]]
        assert w.max() > w.min() or w.size == 1


def test_bags_are_distinct_words_with_unit_mass():
    bags = generate.draw_bags(cpu_gen(3, 2), 200, 50,
                              {"kind": "uniform", "low": 5, "high": 30}, 1.4)
    for i in range(bags.n):
        ids = bags.ids[bags.ptr[i]:bags.ptr[i + 1]]
        assert np.unique(ids).size == ids.size
        assert ((0 <= ids) & (ids < 50)).all()
        assert abs(bags.w[bags.ptr[i]:bags.ptr[i + 1]].sum() - 1) < 1e-5
    idx, val = generate.to_ell(bags)
    assert idx.shape == (200, bags.sizes().max())
    assert np.allclose(val.sum(1), 1, atol=1e-5)


def test_same_seed_same_data_other_seed_other_data():
    cfg = dict(CFG["paper_wmd"], vocab_size=300, embed_dim=8, n_docs=40,
               query_pool={"size": 20,
                           "words": CFG["paper_wmd"]["doc_words"]})
    big = 2**31 + 12345
    a, b, c = (generate.make(cfg, s, "cpu") for s in (big, big, big + 1))
    assert np.array_equal(a.idx, b.idx) and np.array_equal(a.val, b.val)
    assert np.array_equal(a.pool.ids, b.pool.ids)
    assert bool((a.vecs == b.vecs).all())
    assert not np.array_equal(a.idx, c.idx)
    assert not bool((a.vecs == c.vecs).all())


def test_dense_rows_clear_what_they_set():
    bags = generate.draw_bags(cpu_gen(1, 3), 10, 40,
                              {"kind": "uniform", "low": 3, "high": 9}, 1.4)
    rows = generate.DenseRows(2, 40)
    first = rows.fill(bags, [0, 1]).copy()
    second = rows.fill(bags, [5])
    assert second.shape == (1, 40)
    assert np.isclose(second.sum(), 1) and rows.buf[1].sum() == 0
    assert np.isclose(first.sum(), 2)


@pytest.mark.parametrize("name", ["paper_wmd", "news20_knn"])
def test_every_whole_block_of_a_pool_has_the_same_lengths(name):
    pool = CFG[name]["query_pool"]
    block = pool["block"]
    n = 3 * block + 100
    x = generate.draw_lengths(cpu_gen(9, generate.STREAM_POOL), n,
                              pool["words"], block).numpy()
    first = np.sort(x[:block])
    for b in range(1, 3):
        assert np.array_equal(np.sort(x[b * block:(b + 1) * block]), first)
        assert not np.array_equal(x[b * block:(b + 1) * block], x[:block])
    assert pool["size"] % block == 0
