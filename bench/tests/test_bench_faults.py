"""A run with the timed path broken underneath comes out not correct:
once for each fault a search or one-query cell can have. The harness runs
on the host (its look for a card skipped), the program's entry patched
in the run's own process."""
from __future__ import annotations

import pytest

from bench_helpers import host_run

SEARCH = "tiny_paper_wmd.exhaustive_b64"
PRUNED = "tiny_news20_knn.rwmd_b64"
ONE = "tiny_paper_wmd.one_query"

PATCH_SEARCH = """
import numpy as np
from repro_torch.core import index
_search = index.WmdEngine.search
def search(self, *a, **kw):
    res = _search(self, *a, **kw)
    ids, dist = res.indices.copy(), res.distances.copy()
    {body}
    return index.SearchResult(ids, dist, res.solved)
index.WmdEngine.search = search
"""

FAULTS = {
    # an answer altered where it is produced: one id, one distance
    "answer_id": (SEARCH, PATCH_SEARCH.format(
        body="ids[:, 0] = [np.setdiff1d(np.arange(self.index.n_docs), "
             "row)[-1] for row in ids]")),
    "answer_distance": (PRUNED, PATCH_SEARCH.format(
        body="dist[:, 3] *= 1.01")),
    # half of the batch left out
    "half_batch": (SEARCH, PATCH_SEARCH.format(
        body="h = len(ids) // 2; ids[h:] = -1; dist[h:] = np.nan")),
    # a step that returns its state unchanged: the solve never iterates
    "no_iterations": (PRUNED, """
from repro_torch.core import index
_init = index.WmdEngine.__init__
def init(self, *a, **kw):
    _init(self, *a, **kw)
    self.n_iter = 0
index.WmdEngine.__init__ = init
"""),
    "one_query_distance": (ONE, """
import repro_torch.core as core
_otm = core.one_to_many
def otm(*a, **kw):
    out = _otm(*a, **kw).clone()
    out[7::50] *= 1.01
    return out
core.one_to_many = otm
"""),
    "one_query_no_iterations": (ONE, """
import repro_torch.core as core
_otm = core.one_to_many
def otm(r, docs, vecs, lam, n_iter, **kw):
    return _otm(r, docs, vecs, lam, 0, **kw)
core.one_to_many = otm
"""),
}


def test_unbroken_runs_are_correct(tree):
    for cell in (SEARCH, PRUNED, ONE):
        assert host_run(tree, cell, seconds=0.3)["correct"] is True


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_run_is_not_correct(tree, fault):
    cell, patch = FAULTS[fault]
    r = host_run(tree, cell, seconds=0.3, prelude=patch)
    assert r["correct"] is False
    over = [k for k, c in r["checks"].items()
            if c["value"] is None or not float(c["value"]) <= c["limit"]]
    assert over, r["checks"]
