"""Host types of the sharded index (port of part of
``repro.core.shard_index``).

For now this module holds only the two types the serving runtime names:
:class:`ShardSearchError`, the structured failure of a sharded fan-out,
and :class:`ShardCoverage`, how much of the corpus a sharded result
covers. The sharded index itself (``shard_corpus``, snapshots and
``restore_shard``, the one-collective top-k merge and
``ShardedWmdEngine``) is not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple


class ShardSearchError(Exception):
    """Structured shard fan-out failure, naming the shard(s) involved.

    Raised when a shard's dispatch exhausts its retry budget, or by the
    fan-out itself when every shard failed and there is nothing to merge.
    Deliberately not a ``RuntimeError``: the serving ``DispatchGuard``
    classifies ``RuntimeError`` as transient and retryable, and a fan-out
    that already spent its own per-shard retries must not be retried again
    upstream (the ``DispatchFailed`` convention)."""

    def __init__(self, message: str, shard_reasons: dict | None = None):
        super().__init__(message)
        self.shard_reasons = dict(shard_reasons or {})


class ShardCoverage(NamedTuple):
    """How much of the corpus a sharded result actually covers.

    ``fraction == 1.0`` (empty ``missing_shards``) means every shard
    contributed and the usual exactness contract holds; anything less is
    a PARTIAL result: still a true top-k over the responding shards'
    docs, but recall against the full corpus is bounded above by
    ``fraction`` and the serving layer must not claim exactness."""

    fraction: float          # covered docs / corpus docs
    covered_docs: int
    missing_shards: tuple    # shard ids that did not contribute
    reasons: dict            # {shard id: "timeout" | "open_circuit" | error}

    @property
    def full(self) -> bool:
        return not self.missing_shards
