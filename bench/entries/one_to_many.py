"""Drives ``repro_torch.core.one_to_many``: one call takes one
full-vocabulary query row and returns its distance to every document.
The embeddings and documents sit on the device before the first call, in
the form the public entry takes; the mix gives lam, n_iter and impl."""
from __future__ import annotations

import numpy as np
import torch

from bench.traffic.generate import DenseRows, Corpus


class System:
    def __init__(self, corpus: Corpus, config: dict, traffic: dict, device):
        from repro_torch.core.sparse import PaddedDocs
        self.device = torch.device(device)
        self.vecs = corpus.vecs
        self.docs = PaddedDocs(
            idx=torch.as_tensor(corpus.idx, dtype=torch.int64,
                                device=self.device),
            val=torch.as_tensor(corpus.val, device=self.device))
        self.lam = float(traffic["lam"])
        self.n_iter = int(traffic["n_iter"])
        self.impl = traffic["impl"]
        self.pool = corpus.pool
        self.n_docs = corpus.idx.shape[0]
        self.engine = None
        if int(traffic["batch"]) != 1:
            raise ValueError("one_to_many answers one query a call")
        self._rows = DenseRows(1, config["vocab_size"])

    def rows(self, positions) -> np.ndarray:
        return self._rows.fill(self.pool, positions)

    def call(self, rows):
        """-> the (N,) distances on the host."""
        from repro_torch.core import one_to_many
        out = one_to_many(rows[0], self.docs, self.vecs, self.lam,
                          self.n_iter, impl=self.impl, device=self.device)
        return out.cpu().numpy()

    def warm_batches(self, batch: int) -> list:
        """One query of each support size the pool holds, then two from
        the pool's end."""
        size = self.pool.sizes()
        _, first = np.unique(size, return_index=True)
        n = self.pool.n
        return [(int(p),) for p in first] + [(n - 1,), (n - 2,)]

    def answers(self, result) -> list:
        return [result]

    def failed(self, answer) -> bool:
        return bool(answer.shape != (self.n_docs,)
                    or not np.isfinite(answer).all())

    def free(self) -> None:
        self.vecs = self.docs = None


def from_distances(d: np.ndarray, k: int):
    """The answer one_to_many would give from distances ``d``."""
    return d.astype(np.float32)


def compare(answer, ref: np.ndarray, k: int) -> dict:
    """``dist_gap``: the widest gap between the answer's and the
    reference's distance to a document, as a share of the median reference
    distance; a wrong shape or a non-finite distance reads inf."""
    answer = np.asarray(answer, np.float64)
    if answer.shape != ref.shape or not np.isfinite(answer).all():
        return {"dist_gap": float("inf")}
    return {"dist_gap": float(np.abs(answer - ref).max() / np.median(ref))}
