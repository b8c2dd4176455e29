"""The port's corpus generator and ELL containers against the reference:
the same seed gives byte-identical arrays."""
import numpy as np
import pytest

from repro.core import sparse as ref_sparse
from repro.data import corpus as ref_corpus
from repro.data.pipeline import wmd_request_stream as ref_stream
from repro_torch.core import sparse
from repro_torch.data import corpus
from repro_torch.data.pipeline import wmd_request_stream

SHAPES = {
    # make_corpus defaults, cut in width and count
    "default": dict(vocab_size=512, embed_dim=32, n_docs=64, n_queries=3),
    # paper_corpus's document statistics at a small vocabulary
    "paper_shaped": dict(vocab_size=2000, embed_dim=30, n_docs=50,
                         n_queries=10, words_per_doc=(19, 43)),
}


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_make_corpus_byte_identical(shape, seed):
    got = corpus.make_corpus(seed=seed, **SHAPES[shape])
    want = ref_corpus.make_corpus(seed=seed, **SHAPES[shape])
    _same(got.vecs, want.vecs)
    _same(got.docs.idx, want.docs.idx)
    _same(got.docs.val, want.docs.val)
    _same(got.queries, want.queries)


def test_padded_docs_round_trips(rng):
    v, n = 40, 12
    c = np.where(rng.random((v, n)) < 0.15, rng.random((v, n)), 0.0)
    c = (c / np.maximum(c.sum(0, keepdims=True), 1e-9)).astype(np.float32)
    docs = sparse.padded_docs_from_dense(c)
    want = ref_sparse.padded_docs_from_dense(c)
    _same(docs.idx, want.idx)
    _same(docs.val, want.val)
    np.testing.assert_array_equal(sparse.padded_docs_to_dense(docs, v), c)
    assert docs.n_docs == n and docs.max_words == want.max_words

    ids = [np.array([3, 9, 1]), np.array([0]), np.array([5, 6])]
    cnts = [np.array([1.0, 2.0, 1.0]), np.array([4.0]), np.array([1.0, 3.0])]
    got = sparse.padded_docs_from_lists(ids, cnts, max_words=4)
    ref = ref_sparse.padded_docs_from_lists(ids, cnts, max_words=4)
    _same(got.idx, ref.idx)
    _same(got.val, ref.val)
    back = sparse.padded_docs_from_dense(sparse.padded_docs_to_dense(got, 10),
                                         max_words=4)
    np.testing.assert_array_equal(sparse.padded_docs_to_dense(back, 10),
                                  sparse.padded_docs_to_dense(got, 10))
    np.testing.assert_array_equal(docs.mask(), docs.val > 0)


def test_shard_balanced_and_request_stream_match_reference():
    c = corpus.make_corpus(vocab_size=256, embed_dim=8, n_docs=37,
                           n_queries=5, seed=3)
    rc = ref_corpus.make_corpus(vocab_size=256, embed_dim=8, n_docs=37,
                                n_queries=5, seed=3)
    got = corpus.shard_balanced(c.docs, 4)
    want = ref_corpus.shard_balanced(rc.docs, 4)
    _same(got.idx, want.idx)
    _same(got.val, want.val)
    a, b = wmd_request_stream(c, seed=2), ref_stream(rc, seed=2)
    for _ in range(6):
        _same(next(a), next(b))
