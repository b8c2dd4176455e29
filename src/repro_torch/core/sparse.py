"""ELL document containers (port of ``repro.core.sparse``).

``PaddedDocs`` stores each target document j as its word ids
``idx[j, :L]`` and normalized frequencies ``val[j, :L]``, padded to the
collection max ``L``. Fields are numpy arrays on the host (what the
constructors below return) or torch tensors on a device (what the index holds);
the container does not care which.

``BlockSparse`` stores a (V, N) matrix as its nonzero (bv, bn) tiles, the
operand layout of the block-sparse SDDMM kernel
(:func:`repro_torch.kernels.ops.bsr_sddmm`).
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


class BlockSparse(NamedTuple):
    """BSR over a (V, N) matrix with (bv, bn) tiles.

    Only tiles holding at least one nonzero are stored, in row-major order
    over (``brow``, ``bcol``): ``blocks`` holds their dense contents,
    ``brow``/``bcol`` (int32) their tile coordinates. With
    ``pad_blocks_to`` the count is padded with all-zero tiles at
    coordinate (0, 0). ``shape`` is the matrix shape padded up to whole
    tiles."""

    blocks: torch.Tensor    # (n_blocks, bv, bn) tile values
    brow: torch.Tensor      # (n_blocks,) int32 tile row (vocabulary) index
    bcol: torch.Tensor      # (n_blocks,) int32 tile column (doc) index
    shape: tuple            # padded (V, N)

    @property
    def block_shape(self) -> tuple[int, int]:
        return self.blocks.shape[1], self.blocks.shape[2]


def _live_tiles(c, bv: int, bn: int, dtype=None):
    """(padded c viewed as (V/bv, bv, N/bn, bn) tiles, (V/bv, N/bn) bool:
    tile holds a nonzero). ``c`` is a numpy array or a tensor; the work
    runs on the tensor's device (numpy on the host)."""
    c = torch.as_tensor(c)
    if dtype is not None:
        c = c.to(dtype)
    v, n = c.shape
    vp, np_ = -(-v // bv) * bv, -(-n // bn) * bn
    if (vp, np_) != (v, n):
        c = torch.nn.functional.pad(c, (0, np_ - n, 0, vp - v))
    tiles = c.reshape(vp // bv, bv, np_ // bn, bn)
    return tiles, tiles.abs().sum(dim=(1, 3)) > 0


def block_sparse_from_dense(c, bv: int = 128, bn: int = 128,
                            pad_blocks_to: int | None = None,
                            dtype=torch.float32) -> BlockSparse:
    """Keep the nonzero (bv, bn) tiles of a dense (V, N) matrix (numpy or a
    tensor; built on the tensor's device, vectorised). Raises
    ``ValueError`` when ``pad_blocks_to`` is below the live tile count."""
    tiles, live = _live_tiles(c, bv, bn, dtype)
    nz = torch.nonzero(live)                     # row-major, as np.argwhere
    n_live = nz.shape[0]
    total = n_live if pad_blocks_to is None else int(pad_blocks_to)
    if total < n_live:
        raise ValueError(f"pad_blocks_to={total} < {n_live} live tiles")
    total = max(total, 1)
    dev = tiles.device
    blocks = torch.zeros((total, bv, bn), dtype=tiles.dtype, device=dev)
    brow = torch.zeros((total,), dtype=torch.int32, device=dev)
    bcol = torch.zeros((total,), dtype=torch.int32, device=dev)
    blocks[:n_live] = tiles.permute(0, 2, 1, 3)[nz[:, 0], nz[:, 1]]
    brow[:n_live] = nz[:, 0].to(torch.int32)
    bcol[:n_live] = nz[:, 1].to(torch.int32)
    return BlockSparse(blocks=blocks, brow=brow, bcol=bcol,
                       shape=(tiles.shape[0] * bv, tiles.shape[2] * bn))


def block_density(c, bv: int = 128, bn: int = 128) -> float:
    """Fraction of (bv, bn) tiles holding a nonzero: the share of the dense
    work that the block-sparse SDDMM does."""
    _, live = _live_tiles(c, bv, bn)
    return float(live.sum()) / live.numel()
