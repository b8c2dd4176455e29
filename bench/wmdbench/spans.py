"""The program's own spans and counters (``repro_torch.trace``) read over
the traced window.

A reader's ``instrument`` turns the recorder on just before the traced
window (``enable``), and its ``read`` takes what the window recorded
(``records``). Span times are ``time.perf_counter_ns()``, the clock of the
calls' ``t0`` and ``t1``; the profiler's are microseconds on its own
timeline. The offset between the two is the last ``bench.call`` span's end
less the last call's ``t1``. The first call's start less its ``t0`` bounds
it from above: it can read later by the profiler's start-up at its first
event (0.40-0.47 ms on the H100's host), never earlier. Where it reads
earlier by more than ``ANCHOR_US``, or later by more than ``START_US``,
the clocks are not shown to be shared, and the run reads nothing.

A span's self intervals are its interval less its child spans'; device
idle time is put down to a span where its self intervals meet the
window's gaps (``profile.Trace.gaps``). A program without the recorder
reads nothing."""
from __future__ import annotations

import bisect
from collections import defaultdict

ANCHOR_US = 50.0
START_US = 1000.0
# the span names of each part of the search path, as the idle metrics
# and PERF.md's breakdown group them
STAGING = ("wmd.plan", "wmd.stage", "wmd.one.stage")
PRUNE = ("wmd.bound", "wmd.prune", "wmd.subset")
RANK = ("wmd.collect", "wmd.rank")


def enable(system=None) -> None:
    """Turn the program's recorder on (and clear it); nothing where the
    program has none."""
    try:
        from repro_torch import trace
    except ImportError:
        return
    trace.enable()


def records():
    """What the recorder holds (``repro_torch.trace.Records``), or
    ``None`` where the program has no recorder or it recorded nothing."""
    try:
        from repro_torch import trace
    except ImportError:
        return None
    rec = trace.records()
    return rec if rec.spans or rec.counters else None


def answered(tr) -> int:
    """Queries answered in the traced window."""
    return sum(len(c.positions) for c in tr.calls if c.answers is not None)


def offset_us(tr) -> float | None:
    """Profiler time less ``perf_counter`` time, in us, from the last
    call's end; ``None`` where the first call's start disagrees (see the
    module's note)."""
    if not tr.calls:
        return None
    first = tr.window[0] - tr.calls[0].t0 * 1e6
    last = tr.window[1] - tr.calls[-1].t1 * 1e6
    return last if -ANCHOR_US <= first - last <= START_US else None


def self_intervals(spans, offset: float) -> dict:
    """Span id -> its self intervals ``[(start_us, end_us), ...]`` on the
    profiler's timeline: its interval less those of its children."""
    kids = defaultdict(list)
    for s in spans:
        if s.parent is not None:
            kids[s.parent].append((s.start_ns, s.end_ns))
    out = {}
    for s in spans:
        t, parts = s.start_ns, []
        for a, b in sorted(kids.get(s.id, ())):
            if a > t:
                parts.append((t, a))
            t = max(t, b)
        if s.end_ns > t:
            parts.append((t, s.end_ns))
        out[s.id] = [(a / 1e3 + offset, b / 1e3 + offset) for a, b in parts]
    return out


def _overlap(iv: list, gaps: list, starts: list) -> float:
    total = 0.0
    for s, e in iv:
        i = max(0, bisect.bisect_right(starts, s) - 1)
        while i < len(gaps) and gaps[i][0] < e:
            total += max(0.0, min(e, gaps[i][1]) - max(s, gaps[i][0]))
            i += 1
    return total


def idle_by_span(tr, rec) -> dict | None:
    """Device-idle us of the traced window by the span name whose self
    time it fell in; ``None`` for idle time outside every span. ``None``
    in place of the dict where the clocks are not shown to be shared."""
    off = offset_us(tr)
    if off is None:
        return None
    gaps = tr.gaps()
    starts = [g[0] for g in gaps]
    out = defaultdict(float)
    selfs = self_intervals(rec.spans, off)
    for s in rec.spans:
        out[s.name] += _overlap(selfs[s.id], gaps, starts)
    out[None] = sum(e - s for s, e in gaps) - sum(
        v for k, v in out.items() if k is not None)
    return dict(out)


def idle_ms_per_query(run, names) -> float | None:
    """Device-idle ms per answered query in the self time of the spans
    named ``names``; ``None`` where no such span was recorded."""
    tr, rec = run.trace, records()
    if tr is None or rec is None or not answered(tr):
        return None
    idle = idle_by_span(tr, rec)
    if idle is None or not any(n in idle for n in names):
        return None
    return sum(idle.get(n, 0.0) for n in names) / 1e3 / answered(tr)
