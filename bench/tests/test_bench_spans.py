"""The readers of the program's spans and counters (``wmdbench.spans`` and
the ``idle_in_*``, ``h2d_pageable_bytes_per_query`` and
``solve_live_cells_pct`` metrics): the clocks they join, the arithmetic
on hand-built records, and the solve attributes against what
``solve_roofline``'s wrappers log."""
from __future__ import annotations

import json
import pickle
from types import SimpleNamespace

import numpy as np
import pytest

from bench_helpers import ROOT, host_run, tiny_config
from bench.wmdbench import cell as cells, spans
from bench.wmdbench.profile import Trace
from bench.wmdbench.window import Call

NEW = ("idle_in_staging_ms_per_query", "idle_in_prune_ms_per_query",
       "idle_in_rank_ms_per_query", "h2d_pageable_bytes_per_query",
       "solve_live_cells_pct")

# the harness's traced window, kept with what the recorder held
KEEP = """
import pickle
import bench.wmdbench.profile as _P
_orig = _P.traced_calls
def _keep(*a, **kw):
    tr = _orig(*a, **kw)
    from repro_torch import trace
    with open({out!r}, "wb") as f:
        pickle.dump((tr._replace(calls=[c._replace(answers=None)
                                        for c in tr.calls]),
                     [c.answers is not None for c in tr.calls],
                     trace.records()), f)
    return tr
_P.traced_calls = _keep
"""


@pytest.fixture(scope="module")
def kept(tree, tmp_path_factory):
    out = tmp_path_factory.mktemp("kept") / "trace.pkl"
    line = host_run(tree, "tiny_news20_knn.rwmd_b64", seed=2**31 + 11,
                    seconds=0.2, trace=True,
                    prelude=KEEP.format(out=str(out)))
    with open(out, "rb") as f:
        tr, ok, rec = pickle.load(f)
    return line, tr, ok, rec


def test_traced_run_shares_the_profilers_clock(kept):
    """The first call's anchor is no earlier than the last call's, and
    later by no more than the profiler's start-up; each mapped
    ``wmd.kblock`` span holds the K block's GEMM (``aten::matmul``) the
    profiler saw, to 20 us at its ends."""
    _, tr, _, rec = kept
    off = spans.offset_us(tr)
    first = tr.window[0] - tr.calls[0].t0 * 1e6
    assert off == tr.window[1] - tr.calls[-1].t1 * 1e6
    assert -spans.ANCHOR_US <= first - off <= spans.START_US
    mm = sorted((s, e) for n, s, e in tr.host if n == "aten::matmul")
    blocks = [s for s in rec.spans if s.name == "wmd.kblock"]
    assert blocks and len(mm) >= len(blocks)
    for b in blocks:
        lo, hi = b.start_ns / 1e3 + off, b.end_ns / 1e3 + off
        inside = [(s, e) for s, e in mm if lo - 20 <= s and e <= hi + 20]
        assert len(inside) == 1, (lo, hi)


def test_traced_line_reads_the_new_metrics(kept):
    line = kept[0]
    for name in NEW:
        assert name in line["metrics"], name
        assert line["metrics"][name]["value"] >= 0


def _span(i, name, a, b, parent=None, request=None, **attrs):
    from repro_torch.trace import Span
    return Span(name, int(a * 1e3), int(b * 1e3), parent,
                i if request is None else request, i, attrs)


def _run(spans_, gaps, counters=None, answered=4):
    """A run over a window of 0..1000 us whose device is busy outside
    ``gaps``, one call answered ``answered`` queries, profiler time equal
    to perf_counter time plus 500 us."""
    from repro_torch.trace import Records
    busy, t = [], 0.0
    for s, e in gaps:
        if s > t:
            busy.append(("k", 500 + t, 500 + s))
        t = e
    if t < 1000:
        busy.append(("k", 500 + t, 1500))
    tr = Trace(device=busy, host=[], runtime={}, spans={},
               window=(500.0, 1500.0),
               calls=[Call(t0=0.0, t1=1e-3, positions=tuple(range(answered)),
                           answers=object(), error=None)])
    return SimpleNamespace(trace=tr), Records(tuple(spans_), counters or {},
                                              0)


def _read(name, run, rec, monkeypatch):
    monkeypatch.setattr(spans, "records", lambda: rec)
    return cells.metric_reader(name).read(run)


def test_idle_is_put_down_to_self_time(monkeypatch):
    # root 0..1000 with stage 100..300, solve 300..700 (bound 400..500
    # inside it) and rank 800..950; the device idles 0..50, 150..250,
    # 420..480, 650..900 and 990..1000 (us)
    s = [_span(0, "wmd.search", 0, 1000),
         _span(1, "wmd.stage", 100, 300, 0, 0),
         _span(2, "wmd.solve", 300, 700, 0, 0),
         _span(3, "wmd.bound", 400, 500, 2, 0),
         _span(4, "wmd.rank", 800, 950, 0, 0)]
    gaps = [(0, 50), (150, 250), (420, 480), (650, 900), (990, 1000)]
    run, rec = _run(s, gaps)
    assert spans.offset_us(run.trace) == pytest.approx(500.0)
    idle = spans.idle_by_span(run.trace, rec)
    want = {"wmd.search": 50 + 100 + 10, "wmd.stage": 100,
            "wmd.solve": 50, "wmd.bound": 60, "wmd.rank": 100, None: 0.0}
    assert idle == pytest.approx(want)
    # 4 queries answered: us / 1e3 / 4 ms a query
    assert _read("idle_in_staging_ms_per_query", run, rec,
                 monkeypatch) == pytest.approx(100 / 4e3)
    assert _read("idle_in_prune_ms_per_query", run, rec,
                 monkeypatch) == pytest.approx(60 / 4e3)
    assert _read("idle_in_rank_ms_per_query", run, rec,
                 monkeypatch) == pytest.approx(100 / 4e3)
    assert _read("idle_in_rank_ms_per_query.card_paced", run, rec,
                 monkeypatch) == pytest.approx(100 / 4e3)


def test_idle_outside_every_span_and_a_missing_part(monkeypatch):
    s = [_span(0, "wmd.one", 200, 400),
         _span(1, "wmd.one.stage", 200, 300, 0, 0)]
    run, rec = _run(s, [(0, 250), (350, 1000)])
    idle = spans.idle_by_span(run.trace, rec)
    assert idle == pytest.approx({"wmd.one": 50, "wmd.one.stage": 50,
                                  None: 200 + 600})
    assert _read("idle_in_prune_ms_per_query", run, rec,
                 monkeypatch) is None        # no prune span recorded


def test_self_intervals_never_overlap():
    rng = np.random.default_rng(5)
    for _ in range(20):
        out, t, i = [], 0.0, 0

        def nest(lo, hi, parent, root, depth):
            nonlocal i
            me, i = i, i + 1
            out.append(_span(me, f"s{depth}", lo, hi, parent,
                             me if root is None else root))
            cut = np.sort(rng.uniform(lo, hi, 2 * int(rng.integers(0, 3))))
            for a, b in cut.reshape(-1, 2):
                if depth < 3:
                    nest(a, b, me, me if root is None else root, depth + 1)

        while t < 900:
            a = t + rng.uniform(0, 50)
            b = min(1000, a + rng.uniform(10, 200))
            nest(a, b, None, None, 0)
            t = b
        gaps = []
        g = 0.0
        while g < 1000:
            a = g + rng.uniform(0, 40)
            b = min(1000.0, a + rng.uniform(0, 40))
            gaps.append((a, b))
            g = b + 1e-3
        run, rec = _run(out, gaps)
        iv = sorted(x for v in spans.self_intervals(rec.spans, 0.0).values()
                    for x in v)
        assert all(a[1] <= b[0] + 1e-9 for a, b in zip(iv, iv[1:]))
        idle = spans.idle_by_span(run.trace, rec)
        total = sum(b - a for a, b in run.trace.gaps())
        assert sum(v for k, v in idle.items() if k is not None) \
            <= total + 1e-6
        assert idle[None] >= -1e-6


@pytest.mark.parametrize("t0_us,ok", [(-40, True), (-60, False),
                                       (990, True), (1010, False)])
def test_anchors_that_disagree_read_nothing(monkeypatch, t0_us, ok):
    """The first call's anchor may read up to 50 us earlier (jitter) and
    up to 1 ms later (the profiler's start-up) than the last call's."""
    run, rec = _run([_span(0, "wmd.stage", 0, 10)], [(0, 1000)])
    tr = run.trace
    moved = tr._replace(calls=[tr.calls[0]._replace(t0=-t0_us * 1e-6)])
    assert (spans.offset_us(moved) == pytest.approx(500.0)) is ok
    got = _read("idle_in_staging_ms_per_query", SimpleNamespace(trace=moved),
                rec, monkeypatch)
    assert (got is not None) is ok


def test_bytes_and_live_cells(monkeypatch):
    chunk = dict(queries=3, query_words=30, width=16, qp=4)
    s = [_span(0, "wmd.search", 0, 100),
         _span(1, "wmd.chunk", 0, 50, 0, 0, **chunk),
         _span(2, "wmd.solve", 10, 20, 1, 0, docs=5, doc_words=40, n_pad=8,
               l_g=16, stage="seed"),
         _span(3, "wmd.solve", 20, 30, 1, 0, docs=6, doc_words=50, n_pad=8,
               l_g=24, stage="survivor")]
    run, rec = _run(s, [], counters={"h2d_pageable_bytes": 1000})
    assert _read("h2d_pageable_bytes_per_query", run, rec,
                 monkeypatch) == pytest.approx(250.0)
    want = 100.0 * 30 * (40 + 50) / (4 * 16 * 8 * (16 + 24))
    for name in ("solve_live_cells_pct", "solve_live_cells_pct.card_paced"):
        assert _read(name, run, rec, monkeypatch) == pytest.approx(want)


def test_a_program_without_the_recorder_reads_nothing(monkeypatch):
    import builtins
    real = builtins.__import__

    def no_trace(name, globals=None, locals=None, fromlist=(), level=0):
        if name == "repro_torch" and fromlist and "trace" in fromlist:
            raise ImportError("no recorder")
        return real(name, globals, locals, fromlist, level)
    monkeypatch.setattr(builtins, "__import__", no_trace)
    spans.enable()
    assert spans.records() is None
    run, _ = _run([], [])
    for name in NEW:
        assert cells.metric_reader(name).read(run) is None


@pytest.mark.parametrize("mix", ["exhaustive_b64", "rwmd_b64"])
def test_solve_attributes_match_solve_roofline_log(mix):
    """The documents each ``wmd.solve`` met, their live words and the
    chunk's query words equal what ``solve_roofline``'s wrappers log."""
    import torch
    from repro_torch import trace
    from bench.traffic.generate import make
    from bench.entries.search import System
    cfg = tiny_config("news20_knn")
    traffic = json.loads((ROOT / "bench" / "traffic" / f"{mix}.json")
                         .read_text())
    corpus = make(cfg, 2**31 + 5, torch.device("cpu"))
    system = System(corpus, cfg, traffic, "cpu")
    cells.metric_reader("solve_roofline").instrument(system)
    trace.enable()
    try:
        for start in (0, 8):
            system.call(system.rows(tuple(range(start, start + 8))))
    finally:
        trace.disable()
    rec = trace.records()
    by_id = {s.id: s for s in rec.spans}
    solves = [s for s in rec.spans if s.name == "wmd.solve"]
    logged = [e for call in system.solve_log for e in call]
    assert solves and len(solves) == len(logged)
    sizes = corpus.docs.sizes()
    to_ext = system.engine.index.to_external
    for s, (_, v, cols) in zip(solves, logged):
        chunk = by_id[s.parent]
        while chunk.name != "wmd.chunk":
            chunk = by_id[chunk.parent]
        assert s.attrs["docs"] == cols.size
        assert s.attrs["doc_words"] == int(sizes[to_ext(cols)].sum())
        assert chunk.attrs["query_words"] == sum(v)
        assert chunk.attrs["queries"] == len(v)
