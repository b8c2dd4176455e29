"""The reader of the solve's on-chip counters (``solve_onchip_cells_pct``
and its ``.card_paced`` twin) on hand-built records, and on a program
without the recorder."""
from __future__ import annotations

from types import SimpleNamespace

import pytest

import bench_helpers  # noqa: F401  (puts the repository on sys.path)
from bench.wmdbench import cell as cells, spans
from bench.wmdbench.profile import Trace
from bench.wmdbench.window import Call

NAMES = ("solve_onchip_cells_pct", "solve_onchip_cells_pct.card_paced")


def _span(i, name, a, b, parent=None, **attrs):
    from repro_torch.trace import Span
    return Span(name, int(a * 1e3), int(b * 1e3), parent, i, i, attrs)


def _run(spans_):
    """A run over a window of 0..1000 us, the device busy throughout, one
    call that answered four queries."""
    from repro_torch.trace import Records
    tr = Trace(device=[("k", 500.0, 1500.0)], host=[], runtime={}, spans={},
               window=(500.0, 1500.0),
               calls=[Call(t0=0.0, t1=1e-3, positions=tuple(range(4)),
                           answers=object(), error=None)])
    return SimpleNamespace(trace=tr), Records(tuple(spans_), {}, 0)


def _solves(*counts):
    """A search, one chunk past 64 x 64, and one ``wmd.solve`` span per
    entry of ``counts``: (wide_cells, onchip_cells), or None for a span
    without the counts."""
    out = [_span(0, "wmd.search", 0, 100),
           _span(1, "wmd.chunk", 0, 50, 0, queries=2, query_words=300,
                 width=160, qp=2)]
    for i, c in enumerate(counts):
        attrs = dict(docs=5, doc_words=400, n_pad=8, l_g=120, stage="batch")
        if c is not None:
            attrs.update(wide_cells=c[0], onchip_cells=c[1])
        out.append(_span(2 + i, "wmd.solve", 10 + i, 11 + i, 1, **attrs))
    return out


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("counts,want", [
    ([(1000, 900), (0, 0), (3000, 3000)], 97.5),
    ([(0, 0), (0, 0)], None),
    ([None, None], None),
], ids=["share", "no_wide_tile", "no_counts"])
def test_onchip_cells_share(name, counts, want, monkeypatch):
    """100 x the summed ``onchip_cells`` over the summed ``wide_cells`` of
    the ``wmd.solve`` spans; nothing where no span met a tile past 64 x 64,
    or where the spans carry no counts (a program without them)."""
    run, rec = _run(_solves(*counts))
    monkeypatch.setattr(spans, "records", lambda: rec)
    got = cells.metric_reader(name).read(run)
    assert got == (None if want is None else pytest.approx(want))


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
    run, _ = _run([])
    for name in NAMES:
        assert cells.metric_reader(name).read(run) is None
