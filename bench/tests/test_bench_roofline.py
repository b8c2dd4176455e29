"""The frozen work counts against hand counts on tiny shapes."""
from __future__ import annotations

import pytest

from bench.wmdbench import roofline


def test_solve_hand_count():
    # one query of v=2 words against 3 docs of 1, 2 and 3 words (6 in
    # all) among 4 distinct words, 2 iterations:
    # iteration: 4*v*words + v*pairs + words = 48 + 6 + 6 = 60
    # distance line: 7*v*words + v*pairs + words = 84 + 6 + 6 = 96
    w = roofline.solve(v=2, pairs=3, words=6, distinct=4, n_iter=2)
    assert w.flops == 2 * 60 + 96
    # K entries 2*4, r 2, distances 3 -> 13 floats
    assert w.bytes == 4 * 13
    assert roofline.doc_words(6).bytes == 8 * 6


def test_cdist_hand_count():
    # 3 query words, 5 vocabulary words, width 4: 15 pairs of 2*4 + 4 (+1
    # for exp); bytes: rows (5 + 3) * 4 floats, 15 outputs
    assert roofline.cdist(3, 5, 4, k_out=False).flops == 15 * 12
    assert roofline.cdist(3, 5, 4, k_out=True).flops == 15 * 13
    assert roofline.cdist(3, 5, 4, k_out=True).bytes == 4 * (32 + 15)


def test_rwmd_hand_count():
    # queries of 2 and 3 words, 7 vocabulary words, width 4: 5 rows * 7
    # words * (2*4 + 5); bytes: (7 + 5) rows of 4 floats, 2 bound rows of 7
    w = roofline.rwmd([2, 3], 7, 4)
    assert w.flops == 5 * 7 * 13
    assert w.bytes == 4 * (48 + 14)


def test_bound_picks_the_larger_side():
    ops = roofline.Work(roofline.PEAK_FLOPS, 1.0)       # 1 s of operations
    by = roofline.Work(1.0, 2 * roofline.PEAK_BYTES)    # 2 s of bytes
    assert ops.seconds() == pytest.approx(1.0) and ops.binds() == "operations"
    assert by.seconds() == pytest.approx(2.0) and by.binds() == "bytes"
    assert (ops + by).flops == roofline.PEAK_FLOPS + 1.0


def test_solve_counts_the_documents_each_chunk_met():
    from types import SimpleNamespace

    import numpy as np

    from bench.traffic.generate import Bags
    from bench.wmdbench.cell import metric_reader
    mod = metric_reader("solve_roofline")
    # four documents of 1, 2, 3 and 1 words
    docs = Bags(ptr=np.array([0, 1, 3, 6, 7]),
                ids=np.array([5, 1, 5, 2, 3, 4, 9]), w=np.ones(7, np.float32))
    # one call: chunk "a" (queries of 2 and 3 words) solved against
    # documents {0, 1} and then {1, 2}; chunk "b" (1 word) against {3}
    log = [[("a", [2, 3], np.array([0, 1])), ("a", [2, 3], np.array([1, 2])),
            ("b", [1], np.array([3]))]]
    work = mod._work_per_call(log, lambda ids: ids,
                              SimpleNamespace(docs=docs), n_iter=2)
    # chunk a met documents {0, 1, 2}: 6 live words, distinct {1..5}
    want = (roofline.solve(2, 3, 6, 5, 2) + roofline.solve(3, 3, 6, 5, 2)
            + roofline.solve(1, 1, 1, 1, 2) + roofline.doc_words(7))
    assert work == want


def test_solve_log_matches_the_programs_solved_counts():
    """The documents the benchmark sees each pruned chunk solved against
    are as many as ``SearchResult.solved`` says, query by query."""
    import json

    import numpy as np

    from bench_helpers import ROOT, tiny_config
    from bench.entries.search import System
    from bench.traffic.generate import make
    from bench.wmdbench.cell import metric_reader
    cfg = tiny_config("news20_knn")
    mix = json.loads((ROOT / "bench" / "traffic" / "rwmd_b64.json")
                     .read_text())
    mix["batch"] = 8
    system = System(make(cfg, 5, "cpu"), cfg, mix, "cpu")
    metric_reader("solve_roofline").instrument(system)
    _, _, solved = system.call(system.rows(range(8)))
    (entries,) = system.solve_log
    met = {}
    for key, v, cols in entries:
        met.setdefault(key, [len(v), set()])[1].update(cols.tolist())
    assert sum(n * len(docs) for n, docs in met.values()) == solved.sum()
    assert 0 < solved.sum() < 8 * cfg["n_docs"]      # the bound pruned
