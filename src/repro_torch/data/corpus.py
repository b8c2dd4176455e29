"""Synthetic WMD corpus generation + nnz-balanced sharding (port of
``repro.data.corpus``; the same numpy RNG stream, so the arrays are
byte-identical to the reference's for every seed).

The paper's dataset (crawl-300d-2M embeddings subset, V=100k, w=300;
dbpedia documents, N=5000) is reproduced statistically: Zipf-drawn word
ids, 19-43-word queries, Gaussian embeddings.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from repro_torch.core.sparse import PaddedDocs, padded_docs_from_lists


class WmdCorpus(NamedTuple):
    vecs: np.ndarray        # (V, w) embeddings
    docs: PaddedDocs        # N target documents (ELL, numpy fields)
    queries: np.ndarray     # (Q, V) full-vocab frequency rows, normalized


def make_corpus(vocab_size: int = 4096, embed_dim: int = 64,
                n_docs: int = 512, n_queries: int = 4,
                words_per_doc: tuple[int, int] = (8, 40),
                max_words: int | None = None, zipf_a: float = 1.4,
                seed: int = 0, dtype=np.float32) -> WmdCorpus:
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((vocab_size, embed_dim)).astype(dtype)

    def draw_doc():
        n_words = int(rng.integers(words_per_doc[0], words_per_doc[1] + 1))
        # zipf over the vocab, clipped; unique ids with counts
        ids = np.minimum(rng.zipf(zipf_a, size=n_words * 2), vocab_size) - 1
        ids = rng.permutation(vocab_size)[ids % vocab_size]  # decorrelate
        uniq, counts = np.unique(ids[:n_words], return_counts=True)
        return uniq.astype(np.int32), counts.astype(np.float64)

    ids, counts = zip(*[draw_doc() for _ in range(n_docs)])
    docs = padded_docs_from_lists(list(ids), list(counts),
                                  max_words=max_words, dtype=dtype)

    queries = np.zeros((n_queries, vocab_size), dtype=dtype)
    for q in range(n_queries):
        uniq, cnt = draw_doc()
        queries[q, uniq] = cnt / cnt.sum()
    return WmdCorpus(vecs=vecs, docs=docs, queries=queries)


def paper_corpus(seed: int = 0) -> WmdCorpus:
    """Paper-scale corpus: V=100k, w=300, N=5000, 19-43-word documents and
    queries (the shapes behind the paper's Table 1 / Fig 5-7)."""
    return make_corpus(vocab_size=100_000, embed_dim=300, n_docs=5000,
                       n_queries=10, words_per_doc=(19, 43), seed=seed)


def shard_balanced(docs: PaddedDocs, n_shards: int) -> PaddedDocs:
    """nnz-balanced document order: sort docs by nnz, deal round-robin to
    shards, concatenate — every contiguous 1/n_shards slice then has
    ~equal nnz. Pads N up to a multiple of n_shards with one-word docs."""
    idx = np.asarray(docs.idx)
    val = np.asarray(docs.val)
    n, length = idx.shape
    n_pad = -(-n // n_shards) * n_shards
    if n_pad != n:
        idx = np.concatenate([idx, np.zeros((n_pad - n, length), idx.dtype)])
        val = np.concatenate([val, np.zeros((n_pad - n, length), val.dtype)])
        # padded docs get one dummy word of mass 1 to keep x > 0
        val[n:, 0] = 1.0
    nnz = (val > 0).sum(axis=1)
    order = np.argsort(-nnz, kind="stable")
    shards = [order[s::n_shards] for s in range(n_shards)]
    new_order = np.concatenate(shards)
    return PaddedDocs(idx=idx[new_order], val=val[new_order])


# near-duplicate variants per base document, and queries, of the dedup
# corpus (the reference's benchmarks/fig8_topk_prune.py)
DUP = 16
DEDUP_QUERIES = 4


def dedup_corpus(n_docs: int, vocab: int = 8192, embed_dim: int = 64,
                 seed: int = 0) -> WmdCorpus:
    """Near-duplicate corpus: ``n_docs // DUP`` base documents of 19-43
    words, ``DUP`` perturbed variants each (jittered counts, one word
    swapped), and ``DEDUP_QUERIES`` queries drawn as further variants, so
    each query has ~``DUP`` genuinely similar documents and everything else
    is prunable. The port's own copy of the reference benchmark's
    ``dedup_corpus`` (the same numpy RNG stream: byte-identical arrays for
    every seed)."""
    n_base = n_docs // DUP
    base = make_corpus(vocab_size=vocab, embed_dim=embed_dim, n_docs=n_base,
                       n_queries=0, words_per_doc=(19, 43), seed=seed)
    rng = np.random.default_rng(seed + 1)
    idx0 = np.asarray(base.docs.idx)
    val0 = np.asarray(base.docs.val)

    def perturb(j):
        live = val0[j] > 0
        ids = idx0[j][live].copy()
        counts = val0[j][live] * 100.0 + rng.uniform(0.0, 5.0, live.sum())
        ids[rng.integers(0, ids.size)] = rng.integers(0, vocab)  # swap 1 word
        return ids, counts

    lists = [perturb(j) for j in range(n_base) for _ in range(DUP)]
    docs = padded_docs_from_lists([i for i, _ in lists],
                                  [c for _, c in lists])
    queries = np.zeros((DEDUP_QUERIES, vocab), np.float32)
    for qi, j in enumerate(rng.choice(n_base, DEDUP_QUERIES, replace=False)):
        ids, counts = perturb(j)
        queries[qi, ids] = counts / counts.sum()
    return WmdCorpus(vecs=base.vecs, docs=docs, queries=queries)


def zipf_queries(n: int, vocab_size: int, words: int, s: float = 1.0,
                 seed: int = 0) -> list[np.ndarray]:
    """``n`` L1-normalized query histograms of ``words`` draws each, word
    probability proportional to 1/rank**s, with a seeded permutation from
    rank to word id: the Zipfian serving traffic the K-column cache is
    for. The port's own copy of the reference benchmark's
    ``zipf_queries`` (``benchmarks/fig15_kcache.py``; the same numpy RNG
    stream, byte-identical for every seed)."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, vocab_size + 1, dtype=np.float64) ** s
    p /= p.sum()
    rank_to_word = rng.permutation(vocab_size)
    out = []
    for _ in range(n):
        ids = rank_to_word[rng.choice(vocab_size, size=words, p=p)]
        q = np.zeros(vocab_size, np.float32)
        np.add.at(q, ids, rng.random(words).astype(np.float32) + 0.1)
        q /= q.sum()
        out.append(q)
    return out
