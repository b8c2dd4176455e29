"""ELL document containers (port of ``repro.core.sparse``).

``PaddedDocs`` stores each target document j as its word ids
``idx[j, :L]`` and normalized frequencies ``val[j, :L]``, padded to the
collection max ``L``. Fields are numpy arrays on the host (what the
constructors below return) or torch tensors on a device (what the index holds);
the container does not care which. ``BlockSparse`` is not ported yet: it
belongs to the block-sparse SDDMM kernel, which no engine path runs.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class PaddedDocs(NamedTuple):
    """ELL-format document collection: c[idx[j,l], j] = val[j,l]."""

    idx: object   # (N, L) int32 word ids; padding repeats id 0
    val: object   # (N, L) float normalized frequencies; padding == 0

    @property
    def n_docs(self) -> int:
        return self.idx.shape[0]

    @property
    def max_words(self) -> int:
        return self.idx.shape[1]

    def mask(self):
        return self.val > 0


def padded_docs_from_dense(c: np.ndarray, max_words: int | None = None,
                           dtype=np.float32) -> PaddedDocs:
    """Build ELL docs from a dense (V, N) column-normalized matrix; per-doc
    slots are the column-sorted nnz positions, truncated at ``max_words``."""
    c = np.asarray(c)
    v, n = c.shape
    cols, rows = np.nonzero(c.T > 0)        # sorted by doc, then word id
    counts = np.bincount(cols, minlength=n)
    length = int(max_words if max_words is not None
                 else max(1, counts.max(initial=0)))
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(cols.size) - np.repeat(starts, counts)
    keep = slot < length
    idx = np.zeros((n, length), dtype=np.int32)
    val = np.zeros((n, length), dtype=dtype)
    idx[cols[keep], slot[keep]] = rows[keep]
    val[cols[keep], slot[keep]] = c[rows[keep], cols[keep]]
    return PaddedDocs(idx=idx, val=val)


def padded_docs_from_lists(word_ids: list[np.ndarray], counts: list[np.ndarray],
                           max_words: int | None = None,
                           dtype=np.float32) -> PaddedDocs:
    """Build ELL docs from per-document (unique word id, count) lists.
    Frequencies are normalized per document (``sum(c[:, j]) == 1``)."""
    n = len(word_ids)
    length = int(max_words if max_words is not None
                 else max(1, max(len(w) for w in word_ids)))
    idx = np.zeros((n, length), dtype=np.int32)
    val = np.zeros((n, length), dtype=dtype)
    for j, (w, cnt) in enumerate(zip(word_ids, counts)):
        w = np.asarray(w)[:length]
        cnt = np.asarray(cnt, dtype=np.float64)[:length]
        idx[j, : len(w)] = w
        val[j, : len(w)] = (cnt / cnt.sum()).astype(dtype)
    return PaddedDocs(idx=idx, val=val)


def padded_docs_to_dense(docs: PaddedDocs, vocab_size: int):
    """Inverse of :func:`padded_docs_from_dense`; duplicated word ids
    accumulate. The (V, N) matrix is built on ``docs.val``'s device (no
    host round trip); numpy fields give numpy back."""
    val = torch.as_tensor(docs.val)
    idx = torch.as_tensor(docs.idx, device=val.device)
    jj, ll = torch.nonzero(val > 0, as_tuple=True)
    c = torch.zeros((vocab_size, val.shape[0]), dtype=val.dtype,
                    device=val.device)
    c.index_put_((idx[jj, ll].long(), jj), val[jj, ll], accumulate=True)
    return c if isinstance(docs.val, torch.Tensor) else c.numpy()
