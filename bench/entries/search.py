"""Drives ``repro_torch``'s ``WmdEngine.search``: one call answers a batch
of full-vocabulary query rows with each query's k nearest documents.

The engine is built as the configuration states (``engine`` and
``doc_groups`` there); the mix gives k, the prune spec and the mode."""
from __future__ import annotations

import numpy as np

from bench.traffic.generate import DenseRows, Corpus


class System:
    def __init__(self, corpus: Corpus, config: dict, traffic: dict, device):
        from repro_torch.core.index import WmdEngine, build_index
        from repro_torch.core.sparse import PaddedDocs
        eng = dict(config["engine"])
        groups = eng.pop("doc_groups")
        index = build_index(PaddedDocs(idx=corpus.idx, val=corpus.val),
                            corpus.vecs, device=device, doc_groups=groups)
        self.engine = WmdEngine(index, lam=config["lam"],
                                n_iter=config["n_iter"], **eng)
        self.k = int(traffic["k"])
        self.prune = traffic["prune"]
        self.mode = traffic["mode"]
        self.pool = corpus.pool
        self._rows = DenseRows(int(traffic["batch"]), config["vocab_size"])

    def rows(self, positions) -> np.ndarray:
        return self._rows.fill(self.pool, positions)

    def call(self, rows):
        """-> (indices (Q, k), distances (Q, k), solved (Q,)) on the host."""
        res = self.engine.search(list(rows), self.k, prune=self.prune,
                                 mode=self.mode)
        return res.indices, res.distances, res.solved

    def warm_batches(self, batch: int) -> list:
        """Pool positions that reach every chunk width the pool's queries
        make (the engine chunks queries of one width class together), the
        widest first, then two ordinary batches from the pool's end."""
        size = self.pool.sizes()
        per = self.engine.max_batch
        picks = []
        for width in np.unique(-(-size // 8) * 8)[::-1]:
            picks += list(np.nonzero(-(-size // 8) * 8 == width)[0][:per])
        out = [tuple(picks[i:i + batch]) for i in range(0, len(picks),
                                                         batch)]
        n = self.pool.n
        out += [tuple((n - (j + 1) * batch + i) % n for i in range(batch))
                for j in range(2)]
        return out

    def answers(self, result) -> list:
        """One answer per query of a call: (ids, distances, solved)."""
        ids, dist, solved = result
        return [(ids[i], dist[i], int(solved[i])) for i in range(len(ids))]

    def failed(self, answer) -> bool:
        """An answer that cannot be a top-k: a missing id or distance."""
        ids, dist, _ = answer
        return bool(len(ids) != self.k or (ids < 0).any()
                    or not np.isfinite(dist).all())

    def free(self) -> None:
        self.engine = None


def from_distances(d: np.ndarray, k: int):
    """The answer a search would give from distances ``d`` to every
    document (what a control puts in the program's place)."""
    ids = np.argsort(d, kind="stable")[:k]
    return ids, d[ids], d.size


def compare(answer, ref: np.ndarray, k: int) -> dict:
    """``topk_gap``: the widest gap of one query's answer against the
    reference's distances to every document, as a share of the median
    reference distance; the larger of (a) the widest gap between the
    answer's i-th distance and the reference's i-th smallest and (b) the
    widest amount by which the reference puts the answer's i-th document
    above its own i-th smallest (0 where the ids are the true top k,
    near-ties aside). A missing, repeated or out-of-range id, or a
    non-finite distance, reads inf."""
    ids, dist, _ = answer
    scale = float(np.median(ref))
    true = np.sort(ref)[:k]
    ids = np.asarray(ids)
    dist = np.asarray(dist, np.float64)
    if (len(ids) != k or (ids < 0).any() or (ids >= ref.size).any()
            or np.unique(ids).size != k or not np.isfinite(dist).all()):
        return {"topk_gap": float("inf")}
    return {"topk_gap": float(max(np.abs(dist - true).max(),
                                  (ref[ids] - true).max()) / scale)}
