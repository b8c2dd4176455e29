"""Frozen work counts of the WMD layers and the card's peaks.

Every count is of the logical problem, never of how a kernel does it: the
query support sizes v, the documents' live word counts n, the solved
(query, doc) pairs, n_iter, the embedding width w and the vocabulary V.
Padding, tiles, layouts and launches are not counted. Each input byte is
read once and each output byte written once (fp32 values, int32 ids).
An fp32 multiply-add counts as two operations; a reciprocal, square root,
exponential or logarithm as one.

The least time a layer can take is the larger of its operations over the
fp32 peak and its bytes over the memory bandwidth; its roofline share is
that time over the measured device time of its kernels.
"""
from __future__ import annotations

from typing import NamedTuple

# NVIDIA H100 SXM5 80GB datasheet: fp32 (non-tensor) and HBM3
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12


class Work(NamedTuple):
    flops: float
    bytes: float

    def __add__(self, other):
        return Work(self.flops + other.flops, self.bytes + other.bytes)

    def seconds(self) -> float:
        return max(self.flops / PEAK_FLOPS, self.bytes / PEAK_BYTES)

    def binds(self) -> str:
        return ("operations" if self.flops / PEAK_FLOPS
                >= self.bytes / PEAK_BYTES else "bytes")


ZERO = Work(0.0, 0.0)


def solve(v: int, pairs: int, words: float, distinct: float,
          n_iter: int) -> Work:
    """The Sinkhorn solve of one query with ``v`` words against ``pairs``
    documents holding ``words`` live words in all, among ``distinct``
    distinct vocabulary words. Per (query, document) with n words, one
    iteration (u = 1/x, t = K^T u, w = c/t, x = (K/r) w) is 4vn + v + n
    operations; the distance line (u = 1/x, t = K^T u, w = c/t,
    M = -log(K)/lam, then sum u (K.M) w) is 7vn + v + n. Bytes: the K
    entry of each (query word, distinct document word) once, r, and one
    distance per pair out; the documents' ids and frequencies are
    :func:`doc_words`, once per call."""
    vn = float(v) * words
    flops = n_iter * (4 * vn + v * pairs + words) + 7 * vn + v * pairs \
        + words
    nbytes = 4.0 * v * distinct + 4.0 * v + 4.0 * pairs
    return Work(flops, nbytes)


def doc_words(words: float) -> Work:
    """A call's documents: each live word's id and frequency read once."""
    return Work(0.0, 8.0 * words)


def cdist(v: int, vocab: int, w: int, k_out: bool) -> Work:
    """Distances of ``v`` query words to all ``vocab`` words at width
    ``w``: per pair a w-long dot product (2w), |a|^2 + |b|^2 - 2ab and the
    square root (4); with ``k_out`` one exponential more and one (v, V)
    output. Bytes: the vocabulary's and the query's rows once, the
    output."""
    pairs = float(v) * vocab
    flops = pairs * (2 * w + 4 + (1 if k_out else 0))
    nbytes = 4.0 * (vocab * w + v * w) + 4.0 * pairs
    return Work(flops, nbytes)


def rwmd(vs, vocab: int, w: int) -> Work:
    """The RWMD bound of queries with supports ``vs`` over the whole
    vocabulary: each query word's distance to each vocabulary word
    (2w + 4) and the min over the query's words (1). Bytes: the
    vocabulary's rows once, the queries' rows once, one (V,) bound row
    out per query."""
    rows = float(sum(vs))
    flops = rows * vocab * (2 * w + 5)
    nbytes = 4.0 * (vocab * w + rows * w) + 4.0 * len(vs) * vocab
    return Work(flops, nbytes)
